"""% of a move slot's wall time in which the device ran nothing: the
profiled slice's busy seconds per slot against the untraced window's wall
seconds per slot."""
import readers


def read(ctx):
    return readers.idle_share(ctx, "selfplay")
