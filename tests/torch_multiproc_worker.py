"""One rank of the port's data-parallel CPU tests (gloo), run as a
subprocess by ``tests/test_torch_multiprocess.py``:

    python tests/torch_multiproc_worker.py <mode> <rank> <world> <port> <dir>

Every rank joins the process group through the port's own entry point
(``parallel.mesh.initialize_distributed``, ``device="cpu"``), runs one
mode and writes its results under ``<dir>`` for the test to compare:

* ``dp``: 3 ``DPTrainer.step`` calls on the global batches of
  ``<dir>/dp_batches.npz`` from the weights of ``<dir>/dp_init.pt``;
  writes the losses, the gradient norms, the final weights and, per
  parameter, the entries whose gradient in some step was below 1e-3 of
  their largest (``dp_rank<r>.npz``);
* ``selfplay``: this rank's block of a Gumbel and a PUCT self-play batch
  (``dp.sharded_play_games``), ``selfplay_rank<r>.npz``;
* ``pipeline`` / ``pipeline-sharded``: ``AlphaZeroPipeline.train`` for 2
  iterations at the tiny config (replicated or sharded replay; the fetch
  watchdog on, so its collectives run on the watchdog's thread), every
  output under ``<dir>/*_p<r>``; then a pipeline restored from the latest
  checkpoint, and one resumed from iteration 1's and trained to 2;
  writes ``pipeline_rank<r>.json``.

Imports no JAX.
"""
import hashlib
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from alphazero_reversi_tpu_torch.parallel import mesh as mesh_lib  # noqa

GAMES, SEED = 4, 11
LR = 1e-2  # the dp mode's learning rate (the JAX two-process test's)
DP_STEPS = 3


def tiny_model_config():
    from alphazero_reversi_tpu_torch.config import ModelConfig

    return ModelConfig(num_res_blocks=1, num_filters=8,
                       value_head_hidden_size=16, compute_dtype="float32")


def selfplay_kwargs(algorithm: str):
    """The search settings of both sides of the self-play comparison."""
    return dict(num_simulations=4, c_puct=1.0, dirichlet_alpha=0.3,
                dirichlet_epsilon=0.25, temp_threshold=4, temp_init=1.0,
                temp_final=0.1, max_depth=4, max_moves=12, num_stages=1,
                algorithm=algorithm, max_considered_actions=4,
                tree_reuse="root")


def selfplay_net():
    from alphazero_reversi_tpu_torch.models import resnet

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(3)
        return resnet.build_network(tiny_model_config())


def params_sha256(net) -> str:
    digest = hashlib.sha256()
    for name, t in sorted(net.state_dict().items()):
        digest.update(name.encode())
        digest.update(t.detach().cpu().contiguous().numpy().tobytes())
    return digest.hexdigest()


def run_dp(rank: int, out: str) -> None:
    from alphazero_reversi_tpu_torch.config import TrainingConfig
    from alphazero_reversi_tpu_torch.models import resnet
    from alphazero_reversi_tpu_torch.parallel import dp

    net = resnet.build_network(tiny_model_config())
    net.load_state_dict(torch.load(os.path.join(out, "dp_init.pt"),
                                   weights_only=True))
    trainer = dp.DPTrainer(net, TrainingConfig(
        learning_rate=LR, weight_decay=0.0, policy_loss="soft"),
        device="cpu")
    batches = np.load(os.path.join(out, "dp_batches.npz"))
    losses, grad_norms = [], []
    params = dict(trainer.net.named_parameters())
    # each entry's smallest and largest |gradient| (averaged, clipped)
    lo = {name: np.full(p.shape, np.inf, np.float32)
          for name, p in params.items()}
    hi = {name: np.zeros(p.shape, np.float32) for name, p in params.items()}
    for i in range(DP_STEPS):
        aux = trainer.step(*(torch.from_numpy(batches[f"{k}{i}"])
                             for k in ("planes", "policy", "value")))
        losses.append(float(aux["loss"]))
        grad_norms.append(float(aux["grad_norm"]))
        for name, p in params.items():
            g = p.grad.abs().numpy()
            lo[name], hi[name] = np.minimum(lo[name], g), np.maximum(
                hi[name], g)
    np.savez(os.path.join(out, f"dp_rank{rank}.npz"),
             losses=np.asarray(losses), grad_norms=np.asarray(grad_norms),
             **{k: v.numpy() for k, v in trainer.state_dict().items()},
             **{f"amplified:{k}": lo[k] < 1e-3 * hi[k] for k in params})


def run_selfplay(rank: int, out: str) -> None:
    from alphazero_reversi_tpu_torch.parallel import dp

    net = selfplay_net()
    arrays = {}
    for algorithm in ("gumbel", "puct"):
        traj = dp.sharded_play_games(net, num_games=GAMES, seed=SEED,
                                     device="cpu",
                                     **selfplay_kwargs(algorithm))
        for name in ("planes", "policy", "value", "to_move", "valid",
                     "actions"):
            arrays[f"{algorithm}_{name}"] = getattr(traj, name).numpy()
    np.savez(os.path.join(out, f"selfplay_rank{rank}.npz"), **arrays)


def run_pipeline(rank: int, out: str, sharded: bool) -> None:
    from torch_configs import tiny_run_config

    from alphazero_reversi_tpu_torch.parallel import replay_sharded as rs
    from alphazero_reversi_tpu_torch.pipeline import AlphaZeroPipeline

    cfg = tiny_run_config(out, exact_value_empties=12)
    cfg.training.shard_replay_buffer = sharded
    cfg.training.background_checkpoint_fetch = True
    # the gathers, the relabel fetch and the checkpoint copy run under the
    # watchdog, on its thread
    cfg.training.fetch_timeout_s = 120.0
    cfg.logging.save_best_only = False  # iteration 1's checkpoint stays
    # each rank's own outputs: the test checks that rank 1 wrote nothing
    cfg.training.checkpoint_dir = os.path.join(out, f"ckpt_p{rank}")
    cfg.logging.log_dir = os.path.join(out, f"logs_p{rank}")
    cfg.self_play.save_dir = os.path.join(out, f"sp_p{rank}")
    cfg.tournament.output_dir = os.path.join(out, f"tourn_p{rank}")

    pipe = AlphaZeroPipeline(cfg, run_name="mp", device="cpu")
    pipe.train(2)
    result = dict(
        params_sha256=params_sha256(pipe.learner.net),
        best_sha256=params_sha256(pipe.best_net),
        metrics=pipe.metrics_history, eval_units=pipe._last_eval_units,
        replay_sharded=rs.is_sharded(pipe.buffer),
        replay_size=rs.total_size(pipe.buffer),
        rank_replay_size=pipe.buffer.size)

    restored = AlphaZeroPipeline(cfg, run_name="mp_restored", device="cpu")
    result["restored"] = restored.load_checkpoint()
    result["restored_iteration"] = restored.iteration
    result["restored_replay_size"] = rs.total_size(restored.buffer)

    # rank 0 alone reads the checkpoint; the other ranks get its tree
    first = os.path.join(out, "ckpt_p0", "it_000001")
    resumed = AlphaZeroPipeline(cfg, run_name="mp_resumed", device="cpu")
    result["resumed"] = resumed.load_checkpoint(first)
    result["resumed_replay_size"] = rs.total_size(resumed.buffer)
    resumed.train(2)
    result["resumed_params_sha256"] = params_sha256(resumed.learner.net)
    result["resumed_metrics"] = resumed.metrics_history
    with open(os.path.join(out, f"pipeline_rank{rank}.json"), "w") as f:
        json.dump(result, f)


def main() -> None:
    mode, rank, world, port, out = sys.argv[1:6]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    mesh_lib.initialize_distributed(f"127.0.0.1:{port}", world, rank,
                                    device="cpu")
    try:
        if mode == "dp":
            run_dp(rank, out)
        elif mode == "selfplay":
            run_selfplay(rank, out)
        else:
            run_pipeline(rank, out, sharded=mode == "pipeline-sharded")
    finally:
        torch.distributed.destroy_process_group()
    print(f"rank {rank} done", flush=True)


if __name__ == "__main__":
    main()
