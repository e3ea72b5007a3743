"""The FLOP and byte counts against hand counts."""
import json

import harness
import yardstick


def test_forward_flops_at_the_flagship_widths():
    model = json.loads((harness.HERE / "configs" / "flagship.json")
                       .read_text())["model"]
    # stem 64*128*27, 10 convs 64*128*128*9, policy 64*128*2 + 128*65,
    # value 64*128 + 64*256 + 256 multiply-adds
    macs = 221184 + 10 * 9437184 + 16384 + 8320 + 8192 + 16384 + 256
    assert yardstick.forward_flops(model) == 2 * macs == 189285120


def test_search_backup_bytes_by_hand():
    # Gumbel-32, one leaf a round, depth 24, 4 stages: 8 rounds each at 8,
    # 16, 24 and 24 levels; a game's round reads 12 bytes a path entry, 16
    # of its lane and 20 of its root
    per_game = 8 * (12 * 8 + 36) + 8 * (12 * 16 + 36) + 16 * (12 * 24 + 36)
    assert yardstick.search_backup_bytes(2, 32, 1, 24, 4) == 2 * per_game
    # PUCT-400, 16 leaves, 6 stages over 25 rounds: 4 rounds each at 4, 8,
    # 12, 16 and 20 levels, then 5 at 25
    lane = 16 * 16 + 20
    per_game = sum(r * (16 * lv * 12 + lane) for r, lv in
                   ((4, 4), (4, 8), (4, 12), (4, 16), (4, 20), (5, 25)))
    assert per_game == 76980
    assert yardstick.search_backup_bytes(3, 400, 16, 64, 6) == 3 * per_game


def test_peaks():
    assert yardstick.PEAK_BF16_FLOPS == 989e12
    assert yardstick.PEAK_BYTES_PER_S == 3.35e12
