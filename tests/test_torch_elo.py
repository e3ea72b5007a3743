"""The port's ELO copy (``alphazero_reversi_tpu_torch.elo``) against the JAX
package's: the same updates give the same ratings, leaderboard and history,
and each package loads the other's JSON."""
import json

import numpy as np
import pytest

from alphazero_reversi_tpu.elo import ELORatingSystem as JELO
from alphazero_reversi_tpu_torch.elo import ELORatingSystem as TELO


def _play(elo, seed):
    rng = np.random.default_rng(seed)
    names = ["current", "best", "random", "it_000004"]
    elo.add_player("best", 1250.0)
    for _ in range(60):
        a, b = rng.choice(names, 2, replace=False)
        elo.update_ratings(str(a), str(b),
                           float(rng.choice([0.0, 0.5, 1.0])))
    return elo


def _without_time(history):
    return [{k: v for k, v in h.items() if k != "timestamp"}
            for h in history]


@pytest.mark.parametrize("k,initial", [(32.0, 1200.0), (16.0, 1000.0)])
def test_updates_match_jax(k, initial):
    t, j = _play(TELO(k, initial), 1), _play(JELO(k, initial), 1)
    assert t.ratings == j.ratings
    assert t.games_played == j.games_played
    assert t.get_leaderboard() == j.get_leaderboard()
    assert _without_time(t.history) == _without_time(j.history)
    assert t.get_expected_score(1300.0, 1200.0) == \
        j.get_expected_score(1300.0, 1200.0)
    assert t.get_rating("nobody") == j.get_rating("nobody") == initial


def test_json_round_trips_across_packages(tmp_path):
    t, j = _play(TELO(), 2), _play(JELO(), 2)
    t.save_ratings(str(tmp_path / "port" / "elo.json"))
    j.save_ratings(str(tmp_path / "jax.json"))
    port_data = json.loads((tmp_path / "port" / "elo.json").read_text())
    jax_data = json.loads((tmp_path / "jax.json").read_text())
    assert port_data.keys() == jax_data.keys()
    for key in ("k", "initial_rating", "ratings", "games_played"):
        assert port_data[key] == jax_data[key]
    from_jax = TELO.load_ratings(str(tmp_path / "jax.json"))
    from_port = JELO.load_ratings(str(tmp_path / "port" / "elo.json"))
    assert from_jax.get_leaderboard() == from_port.get_leaderboard() \
        == t.get_leaderboard()
    assert _without_time(from_jax.history) == _without_time(t.history)
