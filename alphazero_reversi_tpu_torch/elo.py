"""ELO rating system with JSON persistence.

The port's own copy of ``alphazero_reversi_tpu/elo.py`` (the port imports
nothing of the JAX package): expected score ``1/(1+10^((Rb-Ra)/400))``,
K-factor update, per-game history records, leaderboard sorted by rating,
JSON round-trip. Host-side bookkeeping; the games run batched on the card
(``arena.py``).
"""
from __future__ import annotations

import json
import os
import time
from datetime import datetime
from typing import Dict, List, Optional


class ELORatingSystem:
    """Standard ELO (arena.py:19-135)."""

    def __init__(self, k: float = 32.0, initial_rating: float = 1200.0):
        self.k = k
        self.initial_rating = initial_rating
        self.ratings: Dict[str, float] = {}
        self.games_played: Dict[str, int] = {}
        self.history: List[Dict] = []

    def add_player(self, player_id: str,
                   rating: Optional[float] = None) -> None:
        if player_id not in self.ratings:
            self.ratings[player_id] = (rating if rating is not None
                                       else self.initial_rating)
            self.games_played[player_id] = 0

    def get_rating(self, player_id: str) -> float:
        return self.ratings.get(player_id, self.initial_rating)

    def get_expected_score(self, rating_a: float, rating_b: float) -> float:
        """Expected score of A vs B (arena.py:46-48)."""
        return 1.0 / (1.0 + 10.0 ** ((rating_b - rating_a) / 400.0))

    def update_ratings(self, player_a: str, player_b: str,
                       score_a: float) -> Dict:
        """K-factor update after one game; ``score_a`` in {1.0, 0.5, 0.0}
        (arena.py:50-95)."""
        self.add_player(player_a)
        self.add_player(player_b)
        rating_a = self.ratings[player_a]
        rating_b = self.ratings[player_b]
        expected_a = self.get_expected_score(rating_a, rating_b)
        expected_b = 1.0 - expected_a
        new_a = rating_a + self.k * (score_a - expected_a)
        new_b = rating_b + self.k * ((1.0 - score_a) - expected_b)
        self.ratings[player_a] = new_a
        self.ratings[player_b] = new_b
        self.games_played[player_a] += 1
        self.games_played[player_b] += 1
        record = {
            "timestamp": time.time(),
            "player_a": player_a,
            "player_b": player_b,
            "score_a": score_a,
            "score_b": 1.0 - score_a,
            "rating_a_before": rating_a,
            "rating_b_before": rating_b,
            "rating_a_after": new_a,
            "rating_b_after": new_b,
        }
        self.history.append(record)
        return record

    def get_leaderboard(self) -> List[Dict]:
        """Players sorted by rating, descending (arena.py:97-109)."""
        board = [
            {"player_id": pid, "rating": r,
             "games_played": self.games_played.get(pid, 0)}
            for pid, r in self.ratings.items()
        ]
        board.sort(key=lambda x: x["rating"], reverse=True)
        return board

    def save_ratings(self, filepath: str) -> None:
        """JSON persist (arena.py:111-122)."""
        os.makedirs(os.path.dirname(os.path.abspath(filepath)), exist_ok=True)
        with open(filepath, "w") as f:
            json.dump({
                "k": self.k,
                "initial_rating": self.initial_rating,
                "ratings": self.ratings,
                "games_played": self.games_played,
                "history": self.history,
                "last_updated": datetime.now().isoformat(),
            }, f, indent=2)

    @classmethod
    def load_ratings(cls, filepath: str) -> "ELORatingSystem":
        """JSON load (arena.py:124-135)."""
        with open(filepath) as f:
            data = json.load(f)
        elo = cls(k=data["k"], initial_rating=data["initial_rating"])
        elo.ratings = {k: float(v) for k, v in data["ratings"].items()}
        elo.games_played = {k: int(v) for k, v in
                            data["games_played"].items()}
        elo.history = data.get("history", [])
        return elo
