"""% of the card's bf16 peak (989 TFLOP/s): 3 x the forward FLOPs of every
sample the window trained on (forward and backward, per card), over the
window's seconds."""
import readers


def read(ctx):
    return readers.mfu(ctx, "sgd", 3.0)
