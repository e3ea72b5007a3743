"""% of the bf16 peak reached by the net: forward FLOPs of the slice's rows
over the device time of the operations launched inside the benchmark's
``azbench.net`` spans (one per forward)."""
import readers


def read(ctx):
    return readers.span_roofline(ctx, "selfplay", "azbench.net")
