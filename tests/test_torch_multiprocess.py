"""The port's data parallelism across real processes: 2 gloo ranks on the
CPU, each a subprocess (``tests/torch_multiproc_worker.py``) with a hard
timeout, held against the JAX package and the one-process port.

* DP SGD: 3 ``DPTrainer`` steps against the JAX ``DPTrainer`` on a
  2-device CPU mesh, same weights (carried by ``models/weights.py``) and
  batches, at the lr of the JAX package's own two-process test, 1e-2:
  losses and gradient norms to rel 2e-4 (that test's tolerance; the norm
  is what shows the gradients were averaged over the ranks, not summed,
  which Adam's scale invariance hides from the weights), weights and
  BatchNorm averages to 1e-5 (about 3e-4 of lr times the steps). Adam
  moves an entry by about lr a step whatever its gradient's size, so an
  entry whose gradient in some step was far below its own largest (under
  1e-3 of it, where the float rounding of a sum that nearly cancels is a
  large part of the gradient) is held to 1e-2 lr a step instead; such
  entries must be under 10% of all (496 of 10,888 here; the farthest,
  one of ``value_fc1``, lands 5.1e-5 off, with gradients -1.3e-5, 7.7e-6
  and 4.4e-2).
* Sharded self-play: the two ranks' blocks are the one-process port's
  batch from the same seed: actions, boards and validity exactly, value and
  policy targets to 1e-5.
* The pipeline, both replay modes: equal weights and metrics on both
  ranks, disjoint gate units covering all 6, writes from rank 0 only, and
  a resume that restores the buffer and continues bit for bit.
"""
import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

from alphazero_reversi_tpu.config import MeshConfig as JMeshConfig
from alphazero_reversi_tpu.config import ModelConfig as JModelConfig
from alphazero_reversi_tpu.config import TrainingConfig as JTrainingConfig
from alphazero_reversi_tpu.models import resnet as jresnet
from alphazero_reversi_tpu.parallel import dp as jdp
from alphazero_reversi_tpu.parallel import mesh as jmesh
from alphazero_reversi_tpu_torch import selfplay as tselfplay
from alphazero_reversi_tpu_torch.parallel import mesh as tmesh
from alphazero_reversi_tpu_torch.models.weights import state_dict_from_flax

import torch_multiproc_worker as worker
import torch_parity  # noqa: F401  (one torch thread)
from torch_multiproc_worker import LR

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "torch_multiproc_worker.py")
TIMEOUT_S = 300


def _run_ranks(mode: str, out, world: int = 2) -> None:
    """``world`` worker ranks of ``mode``, each killed at the timeout."""
    tmesh.spawn_ranks(
        lambda r, port: [sys.executable, WORKER, mode, str(r), str(world),
                         str(port), str(out)],
        world, TIMEOUT_S, what=mode)


@pytest.fixture(scope="module")
def jax_dp(tmp_path_factory):
    """3 JAX DP steps on a 2-device mesh, and their inputs for the ranks."""
    out = tmp_path_factory.mktemp("dp")
    jcfg = JModelConfig(num_res_blocks=1, num_filters=8,
                        value_head_hidden_size=16, compute_dtype="float32")
    net = jresnet.build_network(jcfg)
    variables = jresnet.init_variables(net, jax.random.PRNGKey(0))
    host = lambda tree: jax.tree_util.tree_map(np.asarray, tree)
    torch.save(state_dict_from_flax(host(variables),
                                    worker.tiny_model_config()),
               out / "dp_init.pt")
    trainer = jdp.DPTrainer(
        net, variables, JTrainingConfig(learning_rate=LR, weight_decay=0.0,
                                        policy_loss="soft"),
        jmesh.make_mesh(JMeshConfig(data_axis=2, model_axis=1)))
    rng = np.random.RandomState(7)
    batches, losses, grad_norms = {}, [], []
    for i in range(worker.DP_STEPS):
        planes = (rng.rand(16, 8, 8, 3) > 0.5).astype(np.float32)
        policy = rng.rand(16, 65).astype(np.float32)
        policy /= policy.sum(-1, keepdims=True)
        value = rng.rand(16).astype(np.float32) * 2 - 1
        batches.update({f"planes{i}": planes, f"policy{i}": policy,
                        f"value{i}": value})
        aux = trainer.step(planes, policy, value, jax.random.PRNGKey(11))
        losses.append(float(np.asarray(aux["loss"])))
        grad_norms.append(float(np.asarray(aux["grad_norm"])))
    np.savez(out / "dp_batches.npz", **batches)
    final = state_dict_from_flax(host(trainer.variables),
                                 worker.tiny_model_config())
    return out, np.asarray(losses), np.asarray(grad_norms), final


def test_two_rank_dp_matches_jax(jax_dp):
    out, jax_losses, jax_grad_norms, jax_final = jax_dp
    _run_ranks("dp", out)
    ranks = [np.load(out / f"dp_rank{r}.npz") for r in range(2)]
    for name in ranks[0].files:  # the ranks stay identical
        np.testing.assert_array_equal(ranks[0][name], ranks[1][name],
                                      err_msg=name)
    np.testing.assert_allclose(ranks[0]["losses"], jax_losses, rtol=2e-4)
    np.testing.assert_allclose(ranks[0]["grad_norms"], jax_grad_norms,
                               rtol=2e-4)
    entries = amplified_entries = 0
    for name, want in jax_final.items():
        if name.endswith("num_batches_tracked"):
            continue  # the port's BatchNorm does not count batches
        diff = np.abs(ranks[0][name] - want.numpy())
        amplified = ranks[0].get(f"amplified:{name}",
                                 np.zeros(diff.shape, bool))
        entries += diff.size
        amplified_entries += int(amplified.sum())
        assert diff[~amplified].max(initial=0) <= 1e-5, name
        assert diff[amplified].max(initial=0) <= \
            1e-2 * LR * worker.DP_STEPS, name
    assert amplified_entries <= 0.1 * entries, (amplified_entries, entries)


def test_two_rank_sharded_selfplay_is_the_one_process_batch(tmp_path):
    _run_ranks("selfplay", tmp_path)
    ranks = [np.load(tmp_path / f"selfplay_rank{r}.npz") for r in range(2)]
    net = worker.selfplay_net()
    for algorithm in ("gumbel", "puct"):
        gen = torch.Generator().manual_seed(worker.SEED)
        whole = tselfplay.play_games(
            net, num_games=worker.GAMES, generator=gen, device="cpu",
            **worker.selfplay_kwargs(algorithm))
        for name in ("planes", "to_move", "valid", "actions", "value",
                     "policy"):
            got = np.concatenate([r[f"{algorithm}_{name}"] for r in ranks],
                                 axis=1)
            want = getattr(whole, name).numpy()
            if name in ("value", "policy"):
                np.testing.assert_allclose(got, want, atol=1e-5,
                                           err_msg=f"{algorithm} {name}")
            else:
                np.testing.assert_array_equal(got, want,
                                              err_msg=f"{algorithm} {name}")


@pytest.mark.parametrize("mode", ["pipeline", "pipeline-sharded"])
def test_two_rank_pipeline(tmp_path, mode):
    _run_ranks(mode, tmp_path)
    r0, r1 = (json.loads((tmp_path / f"pipeline_rank{r}.json").read_text())
              for r in range(2))
    for key in ("params_sha256", "best_sha256", "replay_size",
                "restored_iteration", "restored_replay_size",
                "resumed_replay_size", "resumed_params_sha256"):
        assert r0[key] == r1[key], key
    strip = lambda rows: [{k: v for k, v in m.items()
                           if not k.endswith("seconds")} for m in rows]
    assert strip(r0["metrics"]) == strip(r1["metrics"])
    assert len(r0["metrics"]) == 2
    assert r0["replay_sharded"] == (mode == "pipeline-sharded")
    if r0["replay_sharded"]:
        assert r0["rank_replay_size"] + r1["rank_replay_size"] == \
            r0["replay_size"]
    # each rank played its own gate units, together all 6
    u0, u1 = set(r0["eval_units"]), set(r1["eval_units"])
    assert u0.isdisjoint(u1) and u0 | u1 == set(range(6))
    # restores: the latest checkpoint holds the final buffer; iteration 1's,
    # trained on to 2, gives the uninterrupted run's weights and metrics
    assert r0["restored"] and r0["restored_iteration"] == 2
    assert r0["restored_replay_size"] == r0["replay_size"] > 0
    assert r0["resumed"]
    assert r0["resumed_replay_size"] == r0["metrics"][0]["replay/size"]
    assert r0["resumed_params_sha256"] == r0["params_sha256"]
    assert strip(r0["resumed_metrics"]) == strip(r0["metrics"][1:])
    # only rank 0 wrote
    assert any(p.name.startswith("it_")
               for p in (tmp_path / "ckpt_p0").iterdir())
    assert (tmp_path / "logs_p0" / "mp" / "metrics.jsonl").exists()
    assert any((tmp_path / "sp_p0").iterdir())
    for name in ("ckpt_p1", "logs_p1", "sp_p1", "tourn_p1"):
        d = tmp_path / name
        assert not d.exists() or not any(d.iterdir()), name
