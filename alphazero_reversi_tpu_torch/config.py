"""Configuration: nested dataclasses with JSON round-trip.

The port's own copy of ``alphazero_reversi_tpu/config.py``: the same
sections, fields, defaults and legacy-key migrations, so every JSON under
``configs/`` loads to an identical ``asdict`` in both packages. Field
meanings are documented at the JAX counterpart. The port reads ``mesh``
(``parallel.mesh.make_mesh``: ``data_axis`` -1 or the number of ranks,
``model_axis`` 1), ``training.shard_replay_buffer`` and
``training.fetch_timeout_s`` as the JAX pipeline does.
"""
from __future__ import annotations

import json
import os
from dataclasses import asdict, dataclass, field
from typing import Any, Dict, List


@dataclass
class ModelConfig:
    board_size: int = 8
    num_res_blocks: int = 5
    num_filters: int = 128
    value_head_hidden_size: int = 256
    policy_head_channels: int = 2
    value_head_channels: int = 1
    dropout: float = 0.0
    compute_dtype: str = "bfloat16"  # params stay float32
    # False = BN-free variant: conv biases instead of BatchNorm
    use_batch_norm: bool = True


@dataclass
class MCTSConfig:
    num_simulations: int = 500
    c_puct: float = 1.0
    dirichlet_alpha: float = 0.03
    dirichlet_epsilon: float = 0.25
    algorithm: str = "puct"  # "puct" | "gumbel"
    max_considered_actions: int = 16  # gumbel: root candidates (top-m)
    c_visit: float = 50.0  # gumbel: sigma(q) visit offset
    c_scale: float = 0.1  # gumbel: sigma(q) scale
    max_depth: int = 24  # static descent-depth bound per simulation
    batch_size: int = 1  # leaves selected per game per simulation round
    num_stages: int = 6  # depth-staged select unroll (results identical)
    exact_endgame_empties: int = 0
    tree_reuse: str = "off"  # "off" | "root"
    tree_reuse_discount: float = 1.0


@dataclass
class SelfPlayConfig:
    num_games: int = 30
    num_parallel_games: int = 64
    save_dir: str = "self_play_data"
    save_every: int = 10
    max_moves: int = 60
    temp_threshold: int = 15
    temp_init: float = 1.0
    temp_final: float = 0.1
    exact_value_empties: int = 0
    exact_value_budget_s: float = 30.0


@dataclass
class TrainingConfig:
    batch_size: int = 64
    num_epochs: int = 10
    learning_rate: float = 0.001
    weight_decay: float = 1e-4
    lr_milestones: List[int] = field(default_factory=list)
    lr_gamma: float = 0.1
    checkpoint_dir: str = "checkpoints"
    save_interval: int = 1
    gradient_clip: float = 1.0
    policy_loss_weight: float = 1.0
    value_loss_weight: float = 1.0
    policy_loss: str = "soft"  # "soft" | "argmax"
    replay_capacity: int = 200_000
    train_on_latest_only: bool = False
    shard_replay_buffer: bool = False
    steps_per_dispatch: int = 1
    augment_symmetries: bool = False
    async_checkpointing: bool = True
    replay_checkpoint_interval: int = 1
    background_checkpoint_fetch: bool = False
    fetch_timeout_s: float = 0.0


@dataclass
class TournamentConfig:
    rounds: int = 20
    num_simulations: int = 500
    c_puct: float = 1.0
    algorithm: str = "puct"
    max_considered_actions: int = 16
    c_visit: float = 50.0
    c_scale: float = 0.1
    games_per_pair: int = 2
    batch_rounds: bool = False
    merge_pairings: bool = False
    tree_reuse: str = "off"
    tree_reuse_discount: float = 1.0
    temperature: float = 0.1
    output_dir: str = "tournament_results"
    elo_file: str = "elo_ratings.json"
    elo_k_factor: float = 32.0
    elo_initial: float = 1200.0
    promotion_elo_margin: float = 0.0


@dataclass
class LoggingConfig:
    log_dir: str = "logs"
    log_level: str = "INFO"
    use_tensorboard: bool = True
    save_checkpoints: bool = True
    save_best_only: bool = True
    verbose: bool = True


@dataclass
class MeshConfig:
    data_axis: int = -1
    model_axis: int = 1


@dataclass
class Config:
    project_name: str = "AlphaZero-Reversi-TPU"
    seed: int = 42
    env_compat: bool = False  # True = replicate reference rule quirks
    model: ModelConfig = field(default_factory=ModelConfig)
    mcts: MCTSConfig = field(default_factory=MCTSConfig)
    self_play: SelfPlayConfig = field(default_factory=SelfPlayConfig)
    training: TrainingConfig = field(default_factory=TrainingConfig)
    tournament: TournamentConfig = field(default_factory=TournamentConfig)
    logging: LoggingConfig = field(default_factory=LoggingConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)

    def to_dict(self) -> Dict[str, Any]:
        return asdict(self)

    def save(self, filepath: str) -> None:
        os.makedirs(os.path.dirname(os.path.abspath(filepath)), exist_ok=True)
        with open(filepath, "w") as f:
            json.dump(self.to_dict(), f, indent=2)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Config":
        # Legacy spellings migrate exactly as in the JAX package:
        # mcts.temperature -> self_play.temp_init, *.temperature_threshold ->
        # self_play.temp_threshold (explicit new-style fields win), and
        # mcts.batch_size < 1 -> 1.
        d = dict(d)
        mcts_raw = dict(d.get("mcts", {}))
        sp_raw = dict(d.get("self_play", {}))
        if "temperature" in mcts_raw and "temp_init" not in sp_raw:
            sp_raw["temp_init"] = mcts_raw["temperature"]
        for legacy in (mcts_raw.get("temperature_threshold"),
                       sp_raw.get("temperature_threshold")):
            if legacy is not None and "temp_threshold" not in sp_raw:
                sp_raw["temp_threshold"] = legacy
        d["self_play"] = sp_raw
        if int(mcts_raw.get("batch_size", 1) or 0) < 1:
            mcts_raw["batch_size"] = 1
        d["mcts"] = mcts_raw
        # tournament gumbel hyperparameters default from the mcts section
        tour_raw = dict(d.get("tournament", {}))
        for name in ("max_considered_actions", "c_visit", "c_scale"):
            if name not in tour_raw and name in mcts_raw:
                tour_raw[name] = mcts_raw[name]
        d["tournament"] = tour_raw

        def sub(section_cls, key):
            raw = dict(d.get(key, {}))
            known = {f.name for f in section_cls.__dataclass_fields__.values()}
            return section_cls(**{k: v for k, v in raw.items() if k in known})

        return cls(
            project_name=d.get("project_name", "AlphaZero-Reversi-TPU"),
            seed=d.get("seed", 42),
            env_compat=d.get("env_compat", False),
            model=sub(ModelConfig, "model"),
            mcts=sub(MCTSConfig, "mcts"),
            self_play=sub(SelfPlayConfig, "self_play"),
            training=sub(TrainingConfig, "training"),
            tournament=sub(TournamentConfig, "tournament"),
            logging=sub(LoggingConfig, "logging"),
            mesh=sub(MeshConfig, "mesh"),
        )

    @classmethod
    def load(cls, filepath: str) -> "Config":
        with open(filepath) as f:
            return cls.from_dict(json.load(f))


def get_default_config() -> Config:
    """Default config with LR milestones derived as in the reference."""
    config = Config()
    config.training.lr_milestones = [
        config.training.num_epochs // 2,
        3 * config.training.num_epochs // 4,
    ]
    return config
