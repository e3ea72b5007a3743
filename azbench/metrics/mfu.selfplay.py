"""% of the card's bf16 peak (989 TFLOP/s): forward FLOPs of every row the
net evaluated in the untraced window (each search that ran evaluates its
games' roots and ``num_simulations`` leaves a game, x FLOPs per position
from the layer shapes), over the window's seconds."""
import readers


def read(ctx):
    return readers.mfu(ctx, "selfplay", 1.0)
