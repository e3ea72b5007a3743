"""% of an SGD step's wall time in which the device ran nothing: the
profiled slice's busy seconds per step against the untraced window's wall
seconds per step."""
import readers


def read(ctx):
    return readers.idle_share(ctx, "sgd")
