"""Training orchestration: self-play -> relabel -> replay -> SGD -> gate ->
checkpoint, one outer iteration at a time.

Port of ``alphazero_reversi_tpu/pipeline.py`` for one device (the mesh,
multi-process and sharded-replay paths are ROADMAP.md queue 1 item 12).
Per iteration:

1. **Self-play**: the learner's weights go into the self-play net, which
   plays ``ceil(num_games / num_parallel_games)`` batches; each is
   relabelled with exact endgame values, saved every ``save_every``
   iterations (``.npz``) and inserted into the replay buffer on the card
   (cleared first with ``train_on_latest_only``).
2. **SGD**: ``ceil(new_positions / batch_size)`` steps, rounded up to whole
   chunks of ``steps_per_dispatch`` (``learner.Learner.steps``); the chunk
   metrics stay on the card until one read at the end.
3. **Gate**: an ``Arena`` of current, best and random
   (``arena.Arena.run_tournament``; the flagship merges the pairings); the
   current net becomes best when its rating beats best's by
   ``promotion_elo_margin``, and the best weights are saved.
4. **Checkpoint** every ``save_interval`` iterations and on interrupt
   (``save_checkpoint``): the host copy on the loop's clock and the write
   in the background, or with ``background_checkpoint_fetch`` both in a
   worker thread; the replay buffer fresh on every
   ``replay_checkpoint_interval``-th save. With TensorBoard, each in-loop
   save is followed by a projector embedding of up to 256 buffered
   positions (``_log_replay_embedding``).

Randomness comes from two generators, both in the checkpoint: one on the
device for SGD (sampling, symmetries, dropout), and one on the host that
draws each self-play batch's and each tournament's seed. The net's initial
weights come from ``config.seed``. So a run resumed from a checkpoint
continues bit for bit as the uninterrupted run would have.

Metric names are the JAX package's, plus ``checkpoint/seconds`` (host time
the loop waits on the save).
"""
from __future__ import annotations

import copy
import math
import threading
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from . import arena as arena_lib
from . import checkpoint as ckpt_lib
from . import learner as learner_lib
from . import replay as replay_lib
from . import selfplay as selfplay_lib
from .config import Config
from .logger import Logger, setup_logger
from .mcts.search import resolve_device
from .models import resnet


class AlphaZeroPipeline:
    """End-to-end training pipeline on ``device`` (default CUDA)."""

    def __init__(self, config: Config, run_name: str = "run",
                 logger: Optional[Logger] = None, device=None):
        self.config = config
        self.device = resolve_device(device)
        # the initial weights come from config.seed; torch's global
        # generator is left as it was
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(config.seed)
            self.net = resnet.build_network(config.model).to(self.device)
        self.learner = learner_lib.Learner(self.net, config.training,
                                           device=self.device)
        self.buffer = replay_lib.create(config.training.replay_capacity,
                                        board_size=config.model.board_size,
                                        device=self.device)
        self.selfplay = selfplay_lib.SelfPlay(
            self.net, config.mcts, config.self_play,
            compat=config.env_compat, device=self.device)
        # best-so-far model for the promotion gate
        self.best_net = copy.deepcopy(self.net)
        restored_best = ckpt_lib.restore_best(
            config.training.checkpoint_dir, map_location=self.device)
        if restored_best is not None:
            self.best_net.load_state_dict(restored_best)
        self.generator = torch.Generator(device=self.device).manual_seed(
            config.seed)
        self.host_generator = torch.Generator().manual_seed(config.seed)

        self.iteration = 0
        self.best_elo = float(config.tournament.elo_initial)
        self.metrics_history: list = []
        self._last_live_fraction = 0.0
        self._last_relabel_stats: Dict[str, float] = {}
        # checkpoint schedule: saves so far, the last fresh host copy of the
        # buffer, and the background save worker with the error it hit
        self._saves_done = 0
        self._replay_host: Optional[Dict[str, Any]] = None
        self._bg_save: Optional[threading.Thread] = None
        self._bg_save_error: Optional[BaseException] = None
        self.logger = logger or setup_logger(
            config.logging.log_dir, run_name, level=config.logging.log_level,
            use_tensorboard=config.logging.use_tensorboard,
            verbose=config.logging.verbose)
        self.logger.log_config(config.to_dict())
        self.logger.log_model_graph(repr(self.net))

    def _draw_seed(self) -> int:
        """A seed for one self-play batch or tournament (host generator)."""
        return int(torch.randint(0, 2 ** 62, (1,),
                                 generator=self.host_generator))

    # -- checkpoint plumbing ----------------------------------------------
    def _checkpoint_tree(self) -> Dict[str, Any]:
        state = self.learner.state
        buf = self.buffer
        return {
            "learner": {"net": state.net.state_dict(),
                        "optimizer": state.optimizer.state_dict(),
                        "step": state.step},
            "best": self.best_net.state_dict(),
            "replay": {"planes": buf.planes, "policy": buf.policy,
                       "value": buf.value, "cursor": buf.cursor,
                       "size": buf.size},
            "iteration": self.iteration,
            "best_elo": self.best_elo,
            "generators": {"device": self.generator.get_state(),
                           "host": self.host_generator.get_state()},
        }

    def _join_bg_save(self) -> None:
        """Wait for the background save worker, if any, and raise the error
        it hit. Called before the next save, a restore and the loop's exit.
        Nothing else needs it: the worker reads only its snapshot."""
        worker, self._bg_save = self._bg_save, None
        if worker is not None:
            worker.join()
        if self._bg_save_error is not None:
            err, self._bg_save_error = self._bg_save_error, None
            raise err

    def _finish_save(self, tree: Dict[str, Any], due: bool, interval: int,
                     iteration: int, async_save: bool,
                     ready: Optional["torch.cuda.Event"] = None) -> str:
        """The save proper: the buffer's last fresh host copy when this save
        is not ``due`` (a fresh one, kept for the next saves, when it is and
        ``interval`` > 1), then ``checkpoint.save_checkpoint`` (host copy
        after ``ready``, see ``checkpoint.to_host``; the write) and the
        prune. Runs on the loop's thread or on the background worker; reads
        only ``tree`` and ``_replay_host``, which no other save touches
        while it runs."""
        t0 = time.perf_counter()
        if not due:
            tree = {**tree, "replay": self._replay_host}
        elif interval > 1:
            self._replay_host = ckpt_lib.to_host(tree["replay"], ready,
                                                 self.device)
            tree = {**tree, "replay": self._replay_host}
        replay_s = time.perf_counter() - t0
        path = ckpt_lib.save_checkpoint(
            self.config.training.checkpoint_dir, iteration, tree,
            async_save=async_save, ready=ready, device=self.device)
        self.logger.info("checkpoint %s: %s (host copy %.3f s, replay %s)",
                         "save scheduled (async)" if async_save else "saved",
                         path, replay_s + ckpt_lib.last_host_copy_seconds(),
                         "fresh" if due else "reused")
        if self.config.logging.save_best_only:
            for old in ckpt_lib.prune_checkpoints(
                    self.config.training.checkpoint_dir, keep_latest=1):
                self.logger.info("pruned old checkpoint: %s", old)
        return path

    def save_checkpoint(self, fresh_replay: bool = False) -> str:
        """Checkpoint the whole training state (``it_<iteration>``), then
        keep only the newest with ``save_best_only``.

        The replay buffer is most of a checkpoint's bytes. With
        ``replay_checkpoint_interval`` K > 1 it is copied fresh only on the
        first save, every K-th save (counted in saves, not iterations) and
        a save with ``fresh_replay`` (the run's last save and the interrupt
        save); the other saves store the last fresh copy (a host-memory
        copy of it, not a copy from the device).

        Returns once the host copy is taken; the write runs in the
        background with ``async_checkpointing``. With
        ``background_checkpoint_fetch`` as well, the loop only clones the
        state on the device (``checkpoint.snapshot``) and a worker thread
        takes the host copy and writes it, overlapping the next iteration.
        The clone is what makes that safe in torch: the replay insert, SGD
        and a promotion write the live tensors in place, so a worker that
        copied them directly would need a join before each of those writes
        (JAX, whose arrays are immutable, joins only before it donates
        them). The clone costs one device copy of the state (about 115 MB
        at the flagship's 200,000-row buffer) and a launch per tensor."""
        self._join_bg_save()  # at most one save in flight
        cfg = self.config.training
        interval = max(1, cfg.replay_checkpoint_interval)
        due = (interval == 1 or fresh_replay or self._saves_done == 0
               or self._saves_done % interval == 0)
        self._saves_done += 1
        tree = self._checkpoint_tree()
        if not due:
            tree["replay"] = None  # the last fresh copy goes in instead
        iteration = self.iteration
        if not (cfg.async_checkpointing and cfg.background_checkpoint_fetch):
            return self._finish_save(tree, due, interval, iteration,
                                     cfg.async_checkpointing)
        clone, ready = ckpt_lib.snapshot(tree, self.device)

        def work():
            try:
                # the worker already runs beside the loop: write in place
                self._finish_save(clone, due, interval, iteration, False,
                                  ready)
            except BaseException as e:  # raised by the next join
                self._bg_save_error = e

        self._bg_save = threading.Thread(target=work, daemon=True,
                                         name=f"bgsave:{iteration}")
        self._bg_save.start()
        return ckpt_lib.checkpoint_path(cfg.checkpoint_dir, iteration)

    def load_checkpoint(self, path: Optional[str] = None) -> bool:
        """Restore the whole training state; ``path=None`` loads the latest.
        Returns False when there is none."""
        self._join_bg_save()
        if path is None:
            path = ckpt_lib.latest_checkpoint(
                self.config.training.checkpoint_dir)
        if path is None:
            return False
        tree = ckpt_lib.restore_checkpoint(path)
        state = self.learner.state
        state.net.load_state_dict(tree["learner"]["net"])
        state.optimizer.load_state_dict(tree["learner"]["optimizer"])
        state.step = int(tree["learner"]["step"])
        self.best_net.load_state_dict(tree["best"])
        rep = tree["replay"]
        for name in ("planes", "policy", "value"):
            getattr(self.buffer, name).copy_(rep[name])
        self.buffer = self.buffer._replace(cursor=int(rep["cursor"]),
                                           size=int(rep["size"]))
        self.generator.set_state(tree["generators"]["device"])
        self.host_generator.set_state(tree["generators"]["host"])
        self.iteration = int(tree["iteration"])
        self.best_elo = float(tree["best_elo"])
        # the replay schedule starts again from the restored state, so no
        # later save stores a buffer copied before the restore
        self._saves_done = 0
        self._replay_host = None
        self.logger.info("resumed from %s at iteration %d", path,
                         self.iteration)
        return True

    # -- phases -------------------------------------------------------------
    def _generate_self_play_data(self) -> int:
        """Self-play, relabel, save and replay insert; returns the number of
        new positions."""
        sp_cfg = self.config.self_play
        self.learner.copy_to(self.net)
        if self.config.training.train_on_latest_only:
            self.buffer = replay_lib.reset(self.buffer)
        num_batches = max(1, math.ceil(sp_cfg.num_games
                                       / sp_cfg.num_parallel_games))
        new_positions = 0
        total_slots = 0
        relabel_stats: Dict[str, float] = {}
        for b in range(num_batches):
            traj = self.selfplay.generate_games(self._draw_seed(),
                                                sp_cfg.num_parallel_games)
            if sp_cfg.exact_value_empties > 0:
                budget = (sp_cfg.exact_value_budget_s
                          if sp_cfg.exact_value_budget_s > 0 else None)
                traj, rstats = selfplay_lib.relabel_exact_values_with_stats(
                    traj, sp_cfg.exact_value_empties,
                    compat=self.config.env_compat, budget_s=budget)
                for k, v in rstats.items():
                    # counts add up over batches; the extremum takes the max
                    if k == "max_empties_solved":
                        relabel_stats[k] = max(relabel_stats.get(k, 0), v)
                    else:
                        relabel_stats[k] = relabel_stats.get(k, 0) + v
                if rstats["skipped"]:
                    self.logger.warning(
                        "exact-value relabel budget (%.0fs) hit: %d/%d "
                        "candidates kept realized labels (deepest solved: "
                        "%d empties)", sp_cfg.exact_value_budget_s,
                        rstats["skipped"], rstats["candidates"],
                        rstats["max_empties_solved"])
            if (sp_cfg.save_every > 0
                    and self.iteration % sp_cfg.save_every == 0):
                selfplay_lib.save_trajectory(
                    traj, sp_cfg.save_dir, f"it{self.iteration:06d}_b{b}")
            planes, policy, value, valid = \
                selfplay_lib.flatten_trajectory(traj)
            self.buffer = replay_lib.add(self.buffer, planes, policy, value,
                                         valid)
            new_positions += int(valid.sum())
            total_slots += valid.numel()
        # lockstep waste: the share of searched (slot, game) cells that were
        # live games
        self._last_live_fraction = new_positions / max(1, total_slots)
        self._last_relabel_stats = relabel_stats
        return new_positions

    def _train_epoch(self, num_positions: int) -> Dict[str, float]:
        """``ceil(num_positions / batch_size)`` SGD steps in whole chunks of
        ``steps_per_dispatch``; metrics averaged over chunks, read once."""
        cfg = self.config.training
        steps = max(1, math.ceil(num_positions / cfg.batch_size))
        chunk = max(1, int(cfg.steps_per_dispatch))
        n_chunks = math.ceil(steps / chunk)
        acc = None
        for _ in range(n_chunks):
            aux = self.learner.steps(self.buffer, self.generator, chunk,
                                     cfg.batch_size)
            acc = aux if acc is None else {k: acc[k] + aux[k] for k in acc}
        host = {k: v.item() / n_chunks for k, v in acc.items()}
        return host | {"steps": n_chunks * chunk}

    def _evaluate_model(self) -> Dict[str, float]:
        """Tournament of current vs best vs random; applies the promotion
        gate and returns the eval metrics."""
        cfg = self.config.tournament
        ar = arena_lib.Arena(cfg, compat=self.config.env_compat,
                             device=self.device)
        ar.add_player("current", self.learner.net)
        ar.add_player("best", self.best_net)
        ar.add_player("random", None)
        leaderboard = ar.run_tournament(self._draw_seed())
        board = {p["player_id"]: p["rating"] for p in leaderboard}
        current_elo = board["current"]
        promoted = current_elo > board["best"] + cfg.promotion_elo_margin
        if promoted:
            self.best_net.load_state_dict(self.learner.state_dict())
            self.best_elo = current_elo
            ckpt_lib.save_best(
                self.config.training.checkpoint_dir,
                self.best_net.state_dict(),
                async_save=self.config.training.async_checkpointing)
            self.logger.info("model promoted to best (elo %.1f > %.1f)",
                             current_elo, board["best"])
        return {"eval/elo": current_elo, "eval/best_elo": self.best_elo,
                "eval/random_elo": board["random"],
                "eval/promoted": float(promoted)}

    def _log_replay_embedding(self, step: int, n: int = 256) -> None:
        """TensorBoard projector embedding of up to ``n`` buffered positions
        (their flattened canonical planes), labelled by value target, as
        ``v=+0.50``. Skipped without TensorBoard or with an empty buffer.

        The sample's generator is seeded from ``(config.seed, 0x10C,
        step)``, never from the training generators, so logging cannot
        change training: the same seed gives the same weights, buffer and
        generator states with TensorBoard on or off."""
        if (not self.config.logging.use_tensorboard or not self.buffer.size
                or self.logger.writer is None):
            return
        seed = int(np.random.SeedSequence(
            [self.config.seed, 0x10C, step]).generate_state(1, np.uint64)[0])
        gen = torch.Generator(device=self.device).manual_seed(seed)
        planes, _, value = replay_lib.sample(self.buffer, gen,
                                             min(n, self.buffer.size))
        flat = planes.reshape(planes.shape[0], -1).cpu()
        labels = [f"v={v:+.2f}" for v in value.tolist()]
        self.logger.log_embedding("replay/positions", flat, metadata=labels,
                                  step=step)

    # -- main loop ----------------------------------------------------------
    def train(self, num_iterations: Optional[int] = None) -> None:
        """Run iterations until ``num_iterations`` (default
        ``training.num_epochs``) are done, counting those of a resumed
        run."""
        total = (num_iterations if num_iterations is not None
                 else self.config.training.num_epochs)
        logging_cfg = self.config.logging
        try:
            while self.iteration < total:
                it = self.iteration
                t0 = time.time()
                self.learner.set_iteration(it)
                n_new = self._generate_self_play_data()
                t_sp = time.time()
                train_metrics = self._train_epoch(n_new)
                t_tr = time.time()
                eval_metrics = self._evaluate_model()
                t_ev = time.time()
                self.iteration = it + 1
                saved = (logging_cfg.save_checkpoints and self.iteration
                         % self.config.training.save_interval == 0)
                if saved:
                    # the run's last checkpoint always carries the live
                    # buffer, whatever replay_checkpoint_interval says
                    self.save_checkpoint(fresh_replay=self.iteration >= total)
                t_ck = time.time()

                metrics = {
                    "train/loss": train_metrics["loss"],
                    "train/policy_loss": train_metrics["policy_loss"],
                    "train/value_loss": train_metrics["value_loss"],
                    "train/lr": learner_lib.current_learning_rate(
                        self.learner.state),
                    "train/grad_norm": train_metrics["grad_norm"],
                    "selfplay/positions": n_new,
                    "selfplay/live_fraction": self._last_live_fraction,
                    "selfplay/seconds": t_sp - t0,
                    "train/seconds": t_tr - t_sp,
                    "eval/seconds": t_ev - t_tr,
                    "checkpoint/seconds": t_ck - t_ev,
                    "replay/size": self.buffer.size,
                    **eval_metrics,
                }
                metrics.update({f"selfplay/relabel_{k}": v for k, v in
                                self._last_relabel_stats.items()})
                self.metrics_history.append(metrics)
                self.logger.log_metrics(metrics, it)
                self.logger.log_learning_rate(metrics["train/lr"], it)
                if saved:
                    self._log_replay_embedding(it)
        except KeyboardInterrupt:
            self.logger.warning("interrupted - saving checkpoint")
            for wait in (self._join_bg_save, ckpt_lib.wait_for_saves):
                try:  # a failed earlier save must not block the rescue
                    wait()
                except Exception as e:
                    self.logger.error("background checkpoint save failed: "
                                      "%s", e)
            # the interrupt save carries the live buffer
            self.save_checkpoint(fresh_replay=True)
            raise
        finally:
            self._join_bg_save()
            ckpt_lib.wait_for_saves()
            if logging_cfg.save_checkpoints and logging_cfg.save_best_only:
                for old in ckpt_lib.prune_checkpoints(
                        self.config.training.checkpoint_dir, keep_latest=1):
                    self.logger.info("pruned old checkpoint: %s", old)


def train_from_config(config: Config, run_name: str = "run",
                      resume: bool = False, device=None
                      ) -> AlphaZeroPipeline:
    """Build a pipeline, optionally resume it from the latest checkpoint,
    and train."""
    pipe = AlphaZeroPipeline(config, run_name=run_name, device=device)
    if resume:
        pipe.load_checkpoint()
    pipe.train()
    return pipe
