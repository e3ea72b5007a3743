"""Host calls that put work on the device (kernel, copy, fill and graph
launches) per SGD step of the profiled slice."""
import readers


def read(ctx):
    return readers.launches_per_unit(ctx, "sgd")
