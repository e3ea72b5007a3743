"""The port's data-parallel layer in one process: the mesh rules, the
data-parallel objects without a process group against the one-device
ones (bit for bit), the sharded buffer's checkpoint form against the JAX package's, the stats and
score merges against the JAX rules (the gathers stubbed with the rows the
ranks would send), the sharded gate against the unsharded one, the host
fetch watchdog, and a process group of one rank (gloo) against no process
group, bit for bit. Two real ranks: ``tests/test_torch_multiprocess.py``.
"""
import json
import os
import threading
import time

import numpy as np
import pytest
import torch
from jax.experimental import multihost_utils

from alphazero_reversi_tpu import replay as jreplay
from alphazero_reversi_tpu.config import MeshConfig as JMeshConfig
from alphazero_reversi_tpu.parallel import mesh as jmesh
from alphazero_reversi_tpu.parallel import multihost as jmh
from alphazero_reversi_tpu.parallel import replay_sharded as jrs
from alphazero_reversi_tpu_torch import checkpoint as ckpt_lib
from alphazero_reversi_tpu_torch import cli, hostfetch
from alphazero_reversi_tpu_torch import learner as learner_lib
from alphazero_reversi_tpu_torch import selfplay as selfplay_lib
from alphazero_reversi_tpu_torch import replay as treplay
from alphazero_reversi_tpu_torch.arena import Arena
from alphazero_reversi_tpu_torch.config import (MeshConfig, ModelConfig,
                                                TournamentConfig,
                                                TrainingConfig)
from alphazero_reversi_tpu_torch.models import resnet
from alphazero_reversi_tpu_torch.parallel import dp
from alphazero_reversi_tpu_torch.parallel import mesh as tmesh
from alphazero_reversi_tpu_torch.parallel import multihost as tmh
from alphazero_reversi_tpu_torch.parallel import replay_sharded as trs
from alphazero_reversi_tpu_torch.pipeline import AlphaZeroPipeline

import torch_parity  # noqa: F401  (one torch thread)
from torch_configs import tiny_run_config

CPU = torch.device("cpu")


# -- mesh ---------------------------------------------------------------

def test_mesh_rules():
    mesh = tmesh.make_mesh(MeshConfig(data_axis=-1, model_axis=1),
                           device="cpu")
    assert (mesh.world, mesh.rank, mesh.device) == (1, 0, CPU)
    assert tmesh.make_mesh(MeshConfig(data_axis=1), device="cpu").world == 1
    with pytest.raises(ValueError, match="data_axis=2"):
        tmesh.make_mesh(MeshConfig(data_axis=2), device="cpu")
    with pytest.raises(ValueError, match="model_axis=2"):
        tmesh.make_mesh(MeshConfig(model_axis=2), device="cpu")
    # no distributed arguments: nothing to join; some of them: an error
    assert not tmesh.initialize_distributed(device="cpu")
    with pytest.raises(ValueError, match="coordinator"):
        tmesh.initialize_distributed("127.0.0.1:1", None, 0, device="cpu")
    with pytest.raises(ValueError, match="outside"):
        tmesh.initialize_distributed("127.0.0.1:1", 2, 2, device="cpu")
    assert tmesh.rank_device("cpu", 3) == CPU


def test_local_rows_and_indivisible_batches():
    x = torch.arange(24).reshape(2, 12)
    for r in range(3):
        mesh = tmesh.Mesh(world=3, rank=r, device=CPU)
        assert torch.equal(tmesh.local_rows(x, mesh, 1),
                           x[:, 4 * r:4 * r + 4])
    two = tmesh.Mesh(world=2, rank=0, device=CPU)
    with pytest.raises(ValueError, match="divide"):
        tmesh.local_rows(torch.zeros(3), two)
    net = resnet.build_network(ModelConfig(num_res_blocks=0, num_filters=4))
    with pytest.raises(ValueError, match="num_games=3"):
        dp.sharded_play_games(net, num_games=3, seed=0, mesh=two)
    trainer = dp.DPTrainer(net, TrainingConfig(), mesh=two)
    with pytest.raises(ValueError, match="batch_size=3"):
        trainer.step(torch.zeros(3, 8, 8, 3), torch.zeros(3, 65),
                     torch.zeros(3))


# -- without a process group: the one-device objects -----------------------

def _tiny_net(dropout: float = 0.0):
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(5)
        return resnet.build_network(ModelConfig(
            num_res_blocks=1, num_filters=8, value_head_hidden_size=16,
            compute_dtype="float32", dropout=dropout))


@pytest.mark.parametrize("algorithm", ["gumbel", "puct"])
def test_sharded_selfplay_without_a_group_is_generate_games(algorithm):
    """The pipeline's one path: at a world of one, ``sharded_play_games``
    (every draw at the batch's shape, all rows kept) plays
    ``SelfPlay.generate_games``' games bit for bit."""
    cfg = tiny_run_config("unused")
    cfg.mcts.algorithm = algorithm
    net = _tiny_net()
    want = selfplay_lib.SelfPlay(net, cfg.mcts, cfg.self_play,
                                 device="cpu").generate_games(13, 4)
    got = dp.sharded_play_games(
        net, num_games=4, seed=13, device="cpu",
        **selfplay_lib.search_kwargs(cfg.mcts, cfg.self_play))
    for name in ("planes", "policy", "value", "to_move", "valid",
                 "actions"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name


def test_dp_trainer_without_a_group_is_the_learner():
    """At a world of one, ``DPTrainer.steps`` and ``step`` (the global
    draws, the reduce hook) equal ``Learner``'s bit for bit, with the
    symmetry and dropout draws on."""
    cfg = TrainingConfig(augment_symmetries=True, learning_rate=1e-2)
    net = _tiny_net(dropout=0.3)
    rng = np.random.default_rng(3)
    buf = treplay.create(64, device="cpu")
    policy = rng.random((48, 65)).astype(np.float32)
    buf = treplay.add(
        buf, torch.from_numpy((rng.random((48, 8, 8, 3)) > 0.5)
                              .astype(np.float32)),
        torch.from_numpy(policy / policy.sum(-1, keepdims=True)),
        torch.from_numpy(rng.random(48).astype(np.float32) * 2 - 1),
        torch.ones(48, dtype=torch.bool))
    runs = []
    for cls in (learner_lib.Learner, dp.DPTrainer):
        trainer = cls(net, cfg, device="cpu")
        gen = torch.Generator().manual_seed(9)
        aux = trainer.steps(buf, gen, 3, 8)
        aux1 = trainer.step(*treplay.sample(buf, gen, 8), generator=gen)
        runs.append((aux, aux1, trainer.state_dict(),
                     trainer.state.optimizer.state_dict()))
    (a, a1, w, opt), (b, b1, v, opt2) = runs
    assert a.keys() == b.keys() and a1.keys() == b1.keys()
    for k in a:
        assert torch.equal(a[k], b[k]) and torch.equal(a1[k], b1[k]), k
    for name in w:
        assert torch.equal(w[name], v[name]), name
    for i, st in opt["state"].items():
        for k, x in st.items():
            assert torch.equal(x, opt2["state"][i][k]), (i, k)


# -- the sharded buffer's checkpoint form ---------------------------------

def _rings(cursors, sizes, cl, seed):
    """``len(sizes)`` host rings of ``cl`` rows with distinct values."""
    rng = np.random.default_rng(seed)
    c = cl * len(sizes)
    return dict(planes=rng.integers(0, 2, (c, 8, 8, 3)).astype(np.int8),
                policy=rng.random((c, 65)).astype(np.float32),
                value=np.arange(1, c + 1, dtype=np.float32),
                cursor=np.asarray(cursors, np.int32),
                size=np.asarray(sizes, np.int32))


RINGS = {"unwrapped": ([3, 5], [3, 5]), "wrapped": ([2, 0], [8, 8]),
         "mixed": ([5, 4], [8, 4]), "empty_shard": ([0, 6], [0, 6])}


@pytest.mark.parametrize("case", sorted(RINGS))
def test_canonical_form_is_the_jax_packages(case):
    """``canonicalize_host`` and ``shard_host`` give the JAX package's
    arrays exactly on the same rings (2 rings of 8 rows)."""
    cursors, sizes = RINGS[case]
    rings = _rings(cursors, sizes, 8, seed=len(case))
    want = jrs.canonicalize_host(jreplay.ReplayBuffer(**rings))
    got = trs.canonicalize_host(treplay.ReplayBuffer(**rings))
    for name in treplay.ReplayBuffer._fields:
        np.testing.assert_array_equal(np.asarray(getattr(got, name)),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    jmesh2 = jmesh.make_mesh(JMeshConfig(data_axis=2, model_axis=1))
    want2 = jrs.shard_host(jmesh2, want)
    got2 = trs.shard_host(got, 2)
    for name in treplay.ReplayBuffer._fields:
        np.testing.assert_array_equal(np.asarray(getattr(got2, name)),
                                      np.asarray(getattr(want2, name)),
                                      err_msg=name)


def test_shard_host_takes_a_wrapped_unsharded_ring_like_jax():
    one = _rings([0], [16], 16, seed=3)
    one.update(cursor=np.int32(5), size=np.int32(16))
    want = jrs.shard_host(jmesh.make_mesh(JMeshConfig(data_axis=2,
                                                      model_axis=1)),
                          jreplay.ReplayBuffer(**one))
    got = trs.shard_host(treplay.ReplayBuffer(**one), 2)
    for name in treplay.ReplayBuffer._fields:
        np.testing.assert_array_equal(np.asarray(getattr(got, name)),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)


@pytest.mark.parametrize("case", sorted(RINGS))
def test_checkpoint_form_restores_each_ring_exactly(case):
    """At the same number of ranks a checkpoint rebuilds every ring slot
    for slot (``restore_layout``): the rows a resumed run samples are the
    uninterrupted run's. At another number of ranks the rows are dealt
    out afresh, none lost."""
    cursors, sizes = RINGS[case]
    rings = _rings(cursors, sizes, 8, seed=len(case))
    canon = trs.canonicalize_host(treplay.ReplayBuffer(**rings))
    rep = {"planes": torch.from_numpy(canon.planes),
           "policy": torch.from_numpy(canon.policy),
           "value": torch.from_numpy(canon.value),
           "cursor": int(canon.cursor), "size": int(canon.size),
           "shard_cursor": cursors, "shard_size": sizes}
    for r in range(2):
        ring = trs.from_checkpoint(rep, tmesh.Mesh(world=2, rank=r,
                                                   device=CPU))
        assert (ring.cursor, ring.size) == (cursors[r], sizes[r])
        filled = np.arange(8) < sizes[r]  # a wrapped ring fills all 8
        for name in ("planes", "policy", "value"):
            np.testing.assert_array_equal(
                getattr(ring, name).numpy()[filled],
                rings[name][8 * r:8 * r + 8][filled], err_msg=name)
    dealt = [trs.from_checkpoint(rep, tmesh.Mesh(world=4, rank=r,
                                                 device=CPU))
             for r in range(4)]
    values = np.concatenate([d.value.numpy()[:d.size] for d in dealt])
    assert sorted(values) == sorted(canon.value[:int(canon.size)])


# -- merges, against the JAX rules ----------------------------------------

def _stub_gathers(monkeypatch, rows: np.ndarray):
    """Both packages' gathers return ``rows`` (what the ranks would
    send)."""
    monkeypatch.setattr(jmh, "is_multiprocess", lambda: True)
    monkeypatch.setattr(multihost_utils, "process_allgather",
                        lambda x: rows)
    monkeypatch.setattr(tmh, "is_initialized", lambda: True)
    monkeypatch.setattr(tmh, "from_local_block",
                        lambda x, axis: torch.from_numpy(rows))


def test_aggregate_stats_rule_is_the_jax_packages(monkeypatch):
    """Counts add up over the ranks; seconds and the deepest solve take
    the max."""
    ranks = [dict(candidates=5, solved=4, unique_solves=3, skipped=1,
                  seconds=1.25, max_empties_solved=10, changed=2),
             dict(candidates=7, solved=7, unique_solves=6, skipped=0,
                  seconds=2.5, max_empties_solved=8, changed=1)]
    keys = sorted(ranks[0])
    rows = np.asarray([[float(r[k]) for k in keys] for r in ranks])
    _stub_gathers(monkeypatch, rows)
    want = jmh.aggregate_stats(ranks[0])
    assert tmh.aggregate_stats(ranks[0]) == want
    assert want["seconds"] == 2.5 and want["candidates"] == 12


def test_gather_unit_scores_keeps_each_owners_row(monkeypatch):
    scores = np.random.default_rng(0).random((2, 6, 4)).astype(np.float32)
    owners = np.arange(6) % 2
    _stub_gathers(monkeypatch, scores)
    want = jmh.gather_unit_scores(scores[0], owners)
    got = tmh.gather_unit_scores(scores[0], owners)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[1], scores[1, 1])


def test_helpers_without_a_process_group():
    assert not tmh.is_multiprocess() and tmh.is_primary()
    assert tmh.broadcast_from_primary(42) == 42
    tmh.barrier("noop")
    stats = {"solved": 3, "seconds": 1.5}
    assert tmh.aggregate_stats(stats) == stats
    assert tmh.global_sum(5) == 5
    x = torch.arange(6.0)
    assert tmh.from_local_block(x, 0) is x


# -- the sharded gate -----------------------------------------------------

def _arena():
    cfg = TournamentConfig(algorithm="gumbel", num_simulations=2,
                           max_considered_actions=2, rounds=1,
                           games_per_pair=4, merge_pairings=True,
                           tree_reuse="root", temperature=0.1)
    ar = Arena(cfg, device="cpu")
    for name, seed in (("current", 1), ("best", 2)):
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            ar.add_player(name, resnet.build_network(ModelConfig(
                num_res_blocks=1, num_filters=8, value_head_hidden_size=16,
                compute_dtype="float32")))
    ar.add_player("random", None)
    return ar


def test_sharded_tournament_is_the_merged_tournament():
    """``run_tournament_sharded`` at 1 shard, and at 2 shards played in
    turn in one process, gives ``run_tournament``'s per-unit scores and
    leaderboard exactly."""
    seed = 17
    whole = _arena()
    board = whole.run_tournament(seed)
    units = whole._tournament_units(seed, 1)
    want_rows = whole.play_units_merged(units)

    one = _arena()
    assert one.run_tournament_sharded(seed) == board
    assert one.units_played == list(range(len(units)))

    rows = {}

    def keep(scores, owners):  # shard 0's rows, kept for shard 1
        rows[0] = scores
        return scores

    def merge(scores, owners):
        rows[1] = scores
        return np.stack([rows[0], scores])[owners, np.arange(len(owners))]

    first, second = _arena(), _arena()
    first.run_tournament_sharded(seed, 0, 2, gather=keep)
    assert second.run_tournament_sharded(seed, 1, 2, gather=merge) == board
    assert first.units_played == [0, 2, 4]
    assert second.units_played == [1, 3, 5]
    for u, want in enumerate(want_rows):  # each unit on its owner shard
        np.testing.assert_array_equal(rows[u % 2][u, :len(want)], want)


# -- host fetch watchdog (the cases of tests/test_hostfetch.py) -----------

def test_guarded_passthrough_without_timeout():
    assert hostfetch.guarded(lambda: 42, None) == 42
    assert hostfetch.guarded(lambda: 42, 0) == 42


def test_device_get_returns_host_tensors_under_watchdog():
    out = hostfetch.device_get({"x": torch.arange(8.0), "n": 3},
                               timeout_s=30.0)
    assert torch.equal(out["x"], torch.arange(8.0)) and out["n"] == 3
    assert hostfetch.last_fetch_seconds() >= 0.0


def test_guarded_raises_on_hang():
    t0 = time.perf_counter()
    with pytest.raises(hostfetch.FetchTimeoutError):
        hostfetch.guarded(lambda: time.sleep(5), timeout_s=0.2,
                          what="stub hang")
    assert time.perf_counter() - t0 < 4.0


def test_guarded_propagates_worker_exception():
    def boom():
        raise ValueError("inner")

    with pytest.raises(ValueError, match="inner"):
        hostfetch.guarded(boom, timeout_s=5.0)


def test_guarded_runs_on_the_callers_card(monkeypatch):
    """The current CUDA device belongs to each thread and a new thread
    starts on card 0: ``guarded``'s worker takes the caller's, so an NCCL
    rank's gather under the watchdog (``_comm_device``) stays on its own
    card. The per-thread device is simulated here."""
    cards = threading.local()
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device",
                        lambda: getattr(cards, "index", 0))
    monkeypatch.setattr(torch.cuda, "set_device",
                        lambda d: setattr(cards, "index", int(d)))
    monkeypatch.setattr(tmh.dist, "get_backend", lambda *a: "nccl")
    torch.cuda.set_device(3)
    seen = []
    other = threading.Thread(target=lambda: seen.append(tmh._comm_device()))
    other.start()
    other.join()
    assert seen == [torch.device("cuda", 0)]  # what a bare thread sees
    for timeout_s in (None, 5.0):
        assert hostfetch.guarded(tmh._comm_device, timeout_s) == \
            torch.device("cuda", 3)
    # a tensor on the host still goes to the current card
    assert tmh._comm_device(torch.zeros(1)) == torch.device("cuda", 3)


def test_stubbed_hanging_device_get(monkeypatch):
    monkeypatch.setattr(hostfetch, "to_cpu", lambda tree: time.sleep(5))
    with pytest.raises(hostfetch.FetchTimeoutError):
        hostfetch.device_get(torch.zeros(4), timeout_s=0.2)


def test_pipeline_checkpoint_copy_is_guarded(tmp_path, monkeypatch):
    """``training.fetch_timeout_s`` guards the checkpoint's host copy: a
    copy that hangs fails fast instead of wedging the pipeline."""
    cfg = tiny_run_config(str(tmp_path))
    cfg.training.fetch_timeout_s = 0.2
    pipe = AlphaZeroPipeline(cfg, run_name="wd", device="cpu")
    monkeypatch.setattr(ckpt_lib, "to_host",
                        lambda *a, **k: time.sleep(5))
    with pytest.raises(hostfetch.FetchTimeoutError):
        pipe.save_checkpoint()


# -- a process group of one rank ------------------------------------------

def test_one_rank_process_group_equals_the_one_device_run(tmp_path):
    """``cli train`` with ``--coordinator ... --num-processes 1`` (gloo)
    takes the data-parallel path (sharded self-play, relabel and gate, DP
    SGD, the trajectory gather, the broadcasts) and gives the run without
    a process group bit for bit: checkpoint, best weights and metrics."""
    roots = {}
    for name, extra in (("plain", []),
                        ("group", ["--coordinator",
                                   f"127.0.0.1:{tmesh.free_port()}",
                                   "--num-processes", "1",
                                   "--process-id", "0"])):
        root = tmp_path / name
        cfg = tiny_run_config(str(root), exact_value_empties=12)
        cfg.save(str(root / "c.json"))
        tmh.COLLECTIVES.clear()
        assert cli.main(["--device", "cpu", "train", "-c",
                         str(root / "c.json"), "--iterations", "1",
                         "--run-name", "run"] + extra) == 0
        roots[name] = (root, dict(tmh.COLLECTIVES))
    assert not tmesh.is_initialized()  # the CLI left the group
    assert roots["plain"][1] == {}
    counts = roots["group"][1]
    for kind in ("all_gather", "all_reduce", "broadcast", "barrier"):
        assert counts.get(kind, 0) > 0, counts

    def tree(root):
        return ckpt_lib.restore_checkpoint(
            str(root / "checkpoints" / "it_000001"))

    def equal(a, b, path="tree"):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b), path
        elif isinstance(a, dict):
            assert a.keys() == b.keys(), path
            for k in a:
                equal(a[k], b[k], f"{path}.{k}")
        elif isinstance(a, (list, tuple)):
            assert len(a) == len(b), path
            for i, (x, y) in enumerate(zip(a, b)):
                equal(x, y, f"{path}[{i}]")
        else:
            assert a == b, path

    equal(tree(roots["plain"][0]), tree(roots["group"][0]))

    def metrics(root):
        path = os.path.join(str(root), "logs", "run", "metrics.jsonl")
        with open(path) as f:
            return [{k: v for k, v in json.loads(line).items()
                     if not k.endswith("seconds")} for line in f]

    assert metrics(roots["plain"][0]) == metrics(roots["group"][0])
