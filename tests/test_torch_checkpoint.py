"""The port's checkpoints (``alphazero_reversi_tpu_torch.checkpoint``): an
exact round trip of the pipeline's whole state into a fresh pipeline, host
copies taken at save time, atomic writes (an interrupted write is never
found), background writes, pruning and the best model."""
import os
import threading

import numpy as np
import pytest
import torch

from alphazero_reversi_tpu_torch import checkpoint as ckpt
from alphazero_reversi_tpu_torch import pipeline as tpipeline
from alphazero_reversi_tpu_torch import replay
from alphazero_reversi_tpu_torch.env import bitboard as tenv
import torch_parity  # noqa: F401  (one torch thread)
from torch_configs import tiny_run_config


def _trained_pipeline(root, seed):
    """A tiny CPU pipeline with a filled buffer, AdamW state and advanced
    generators, without running an iteration."""
    pipe = tpipeline.AlphaZeroPipeline(tiny_run_config(str(root)),
                                       device="cpu")
    rng = np.random.default_rng(seed)
    n = 96
    s = tenv.initial_state((n,))
    for _ in range(int(rng.integers(4, 20))):
        mask = tenv.legal_action_mask(s).numpy()
        act = np.array([rng.choice(np.flatnonzero(m)) if m.any() else 64
                        for m in mask])
        s, _ = tenv.step(s, torch.from_numpy(act))
    policy = torch.from_numpy(rng.dirichlet(np.ones(65), n)
                              .astype(np.float32))
    value = torch.from_numpy(rng.integers(-1, 2, n).astype(np.float32))
    pipe.buffer = replay.add(pipe.buffer, tenv.canonical_planes(s), policy,
                             value, torch.ones(n, dtype=torch.bool))
    pipe.learner.steps(pipe.buffer, pipe.generator, 3, 16)
    pipe._draw_seed()
    with torch.no_grad():
        for p in pipe.best_net.parameters():
            p.mul_(0.5)
    pipe.iteration, pipe.best_elo = 5, 1234.5
    return pipe


def _assert_pipelines_equal(a, b):
    for x, y in zip(a.learner.state_dict().values(),
                    b.learner.state_dict().values()):
        assert torch.equal(x, y)
    sa, sb = (p.learner.state.optimizer.state_dict() for p in (a, b))
    assert sa["param_groups"] == sb["param_groups"]
    for i, st in sa["state"].items():
        for k, v in st.items():
            assert torch.equal(v, sb["state"][i][k]), (i, k)
    assert a.learner.state.step == b.learner.state.step == 3
    for x, y in zip(a.best_net.state_dict().values(),
                    b.best_net.state_dict().values()):
        assert torch.equal(x, y)
    for x, y in zip(a.buffer, b.buffer):
        assert torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
    assert torch.equal(a.generator.get_state(), b.generator.get_state())
    assert torch.equal(a.host_generator.get_state(),
                       b.host_generator.get_state())
    assert (a.iteration, a.best_elo) == (b.iteration, b.best_elo)


@pytest.mark.parametrize("async_save", [False, True], ids=["sync", "async"])
def test_pipeline_round_trip_exact(tmp_path, async_save):
    """Parameters, BatchNorm statistics, AdamW's state, best weights, the
    replay buffer with cursor and size, both generators, iteration and
    best ELO come back equal in a fresh pipeline; and the next draws of the
    generators agree."""
    src = _trained_pipeline(tmp_path, 0)
    src.config.training.async_checkpointing = async_save
    path = src.save_checkpoint()
    assert path.endswith("it_000005")
    ckpt.wait_for_saves()
    fresh = tpipeline.AlphaZeroPipeline(tiny_run_config(str(tmp_path)),
                                        device="cpu")
    assert fresh.load_checkpoint()
    _assert_pipelines_equal(src, fresh)
    assert src._draw_seed() == fresh._draw_seed()
    assert torch.equal(torch.rand(4, generator=src.generator),
                       torch.rand(4, generator=fresh.generator))


def test_save_copies_before_returning(tmp_path):
    """The host copy is taken when ``save_checkpoint`` returns: in-place
    changes afterwards (the next SGD step) do not reach the file, even
    while a background write is in flight."""
    w = torch.arange(6.0)
    ckpt.save_checkpoint(str(tmp_path), 1, {"w": w, "n": 3},
                         async_save=True)
    w.add_(100.0)
    tree = ckpt.restore_checkpoint(ckpt.latest_checkpoint(str(tmp_path)))
    assert torch.equal(tree["w"], torch.arange(6.0)) and tree["n"] == 3


def test_interrupted_write_is_never_found(tmp_path, monkeypatch):
    """A failing write leaves no ``it_`` directory and no temporary
    directory; a stale temporary directory from a killed process is
    ignored; the error surfaces at the next wait."""
    ckpt.save_checkpoint(str(tmp_path), 3, {"x": torch.ones(2)})
    stale = tmp_path / ".tmp_it_000009_dead"
    stale.mkdir()
    (stale / ckpt.STATE_FILE).write_bytes(b"half a checkpo")

    def broken(*args, **kwargs):
        raise OSError("disk full")

    monkeypatch.setattr(torch, "save", broken)
    ckpt.save_checkpoint(str(tmp_path), 4, {"x": torch.zeros(2)},
                         async_save=True)
    with pytest.raises(OSError, match="disk full"):
        ckpt.wait_for_saves()
    assert ckpt.latest_checkpoint(str(tmp_path)).endswith("it_000003")
    names = sorted(os.listdir(tmp_path))
    assert names == [".tmp_it_000009_dead", "it_000003"]
    ckpt.wait_for_saves()  # the error was raised once


def test_overwrite_replaces_atomically(tmp_path):
    ckpt.save_checkpoint(str(tmp_path), 2, {"x": torch.ones(2)})
    ckpt.save_checkpoint(str(tmp_path), 2, {"x": torch.full((2,), 7.0)})
    assert sorted(os.listdir(tmp_path)) == ["it_000002"]
    tree = ckpt.restore_checkpoint(str(tmp_path / "it_000002"))
    assert torch.equal(tree["x"], torch.full((2,), 7.0))


def test_interrupted_overwrite_keeps_the_old_checkpoint(tmp_path,
                                                        monkeypatch):
    """An interrupt between moving the old checkpoint aside and renaming the
    new one into place puts the old one back."""
    ckpt.save_checkpoint(str(tmp_path), 2, {"x": torch.ones(2)})
    rename = os.rename

    def interrupted(src, dst):
        if os.path.basename(src).startswith(".tmp_"):
            raise KeyboardInterrupt
        rename(src, dst)

    monkeypatch.setattr(os, "rename", interrupted)
    with pytest.raises(KeyboardInterrupt):
        ckpt.save_checkpoint(str(tmp_path), 2, {"x": torch.zeros(2)})
    monkeypatch.setattr(os, "rename", rename)
    assert sorted(os.listdir(tmp_path)) == ["it_000002"]
    tree = ckpt.restore_checkpoint(ckpt.latest_checkpoint(str(tmp_path)))
    assert torch.equal(tree["x"], torch.ones(2))


def test_prune_keeps_newest(tmp_path):
    for it in (1, 2, 10, 3):
        ckpt.save_checkpoint(str(tmp_path), it, {"it": it})
    ckpt.save_best(str(tmp_path), {"w": torch.ones(1)})
    doomed = ckpt.prune_checkpoints(str(tmp_path), keep_latest=2)
    assert [os.path.basename(p) for p in doomed] == ["it_000001",
                                                     "it_000002"]
    assert sorted(os.listdir(tmp_path)) == ["best_model", "it_000003",
                                            "it_000010"]
    assert ckpt.prune_checkpoints(str(tmp_path / "missing")) == []


def test_best_model_round_trip(tmp_path):
    assert ckpt.restore_best(str(tmp_path)) is None
    weights = {"a": torch.randn(3, 3), "b": torch.arange(4)}
    ckpt.save_best(str(tmp_path), weights, async_save=True)
    got = ckpt.restore_best(str(tmp_path))
    assert got.keys() == weights.keys()
    assert all(torch.equal(got[k], weights[k]) for k in weights)
    # a pipeline built on that directory starts from the best weights
    cfg = tiny_run_config(str(tmp_path))
    pipe = tpipeline.AlphaZeroPipeline(cfg, device="cpu")
    ckpt.save_best(cfg.training.checkpoint_dir,
                   {k: v * 2 for k, v in pipe.net.state_dict().items()})
    again = tpipeline.AlphaZeroPipeline(cfg, device="cpu")
    for k, v in again.best_net.state_dict().items():
        assert torch.equal(v, pipe.net.state_dict()[k] * 2)


# ------------------------------------------- replay interval, background
def _add_rows(pipe, seed, n=8):
    """Insert ``n`` fresh random rows, so the live buffer changes."""
    rng = np.random.default_rng(seed)
    planes = torch.from_numpy(rng.integers(0, 2, (n, 8, 8, 3))
                              .astype(np.float32))
    policy = torch.from_numpy(rng.dirichlet(np.ones(65), n)
                              .astype(np.float32))
    value = torch.from_numpy(rng.uniform(-1, 1, n).astype(np.float32))
    pipe.buffer = replay.add(pipe.buffer, planes, policy, value,
                             torch.ones(n, dtype=torch.bool))


def _buffer(pipe):
    b = pipe.buffer
    return {"planes": b.planes.clone(), "policy": b.policy.clone(),
            "value": b.value.clone(), "cursor": b.cursor, "size": b.size}


def _saved_buffer(pipe, iteration):
    ckpt.wait_for_saves()
    return ckpt.restore_checkpoint(ckpt.checkpoint_path(
        pipe.config.training.checkpoint_dir, iteration))["replay"]


def _assert_buffers_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]) if k in ("planes", "policy", "value") \
            else a[k] == b[k], k


@pytest.mark.parametrize("background", [False, True],
                         ids=["loop", "background"])
def test_replay_checkpoint_interval(tmp_path, background):
    """At interval 2 over 4 saves (counted in saves), saves 1 and 3 carry
    the live buffer and saves 2 and 4 the last fresh copy; a save with
    ``fresh_replay`` (the run's last or the interrupt save) carries the
    live buffer whatever the count. The background fetch saves the same."""
    pipe = _trained_pipeline(tmp_path, 1)
    tr = pipe.config.training
    tr.replay_checkpoint_interval = 2
    tr.async_checkpointing = tr.background_checkpoint_fetch = background
    pipe.config.logging.save_best_only = False
    live, fresh = [], []
    for it, fresh_replay in ((1, False), (2, False), (3, False), (4, False),
                             (5, True)):
        _add_rows(pipe, it)
        pipe.iteration = it
        live.append(_buffer(pipe))
        pipe.save_checkpoint(fresh_replay=fresh_replay)
    pipe._join_bg_save()
    want = [live[0], live[0], live[2], live[2], live[4]]
    for it, w in enumerate(want, 1):
        _assert_buffers_equal(_saved_buffer(pipe, it), w)
    assert not torch.equal(live[0]["planes"], live[1]["planes"])


@pytest.mark.parametrize("background", [False, True],
                         ids=["loop", "background"])
def test_restore_restarts_the_replay_schedule(tmp_path, background):
    """A restore starts the save count again, as the JAX pipeline's does:
    at interval 2, after three saves (the third fresh), a restore of save
    1 makes the next save due, holding the restored buffer and not the
    copy taken before the restore, and the save after it reuse that."""
    pipe = _trained_pipeline(tmp_path, 4)
    tr = pipe.config.training
    tr.replay_checkpoint_interval = 2
    tr.async_checkpointing = tr.background_checkpoint_fetch = background
    pipe.config.logging.save_best_only = False
    for it, fresh_replay in ((1, False), (2, False), (3, True)):
        _add_rows(pipe, 10 + it)
        pipe.iteration = it
        pipe.save_checkpoint(fresh_replay=fresh_replay)
    assert pipe.load_checkpoint(ckpt.checkpoint_path(tr.checkpoint_dir, 1))
    restored = _buffer(pipe)
    pipe.iteration = 4
    pipe.save_checkpoint()  # due: the first save since the restore
    _add_rows(pipe, 15)
    pipe.iteration = 5
    pipe.save_checkpoint()  # not due: the restored buffer again
    pipe._join_bg_save()
    _assert_buffers_equal(_saved_buffer(pipe, 4), restored)
    _assert_buffers_equal(_saved_buffer(pipe, 5), restored)
    assert _saved_buffer(pipe, 3)["size"] > restored["size"]


def _fake_phases(pipe, monkeypatch, interrupt_at=None):
    """Replace the iteration's phases by an insert of fresh rows and fixed
    metrics; the SGD phase of iteration ``interrupt_at`` is interrupted."""
    def selfplay():
        _add_rows(pipe, 100 + pipe.iteration)
        return 8

    def train(n):
        if pipe.iteration == interrupt_at:
            raise KeyboardInterrupt
        return {"loss": 1.0, "policy_loss": 0.5, "value_loss": 0.5,
                "grad_norm": 1.0, "steps": 1}

    monkeypatch.setattr(pipe, "_generate_self_play_data", selfplay)
    monkeypatch.setattr(pipe, "_train_epoch", train)
    monkeypatch.setattr(pipe, "_evaluate_model", lambda: {
        "eval/elo": 0.0, "eval/best_elo": 0.0, "eval/random_elo": 0.0,
        "eval/promoted": 0.0})


def test_final_and_interrupt_saves_carry_the_live_buffer(tmp_path,
                                                         monkeypatch):
    """Through ``train`` at interval 3: the run's last save (its second)
    carries the live buffer, not the first save's; a save forced by an
    interrupt in the next iteration carries the buffer as the interrupted
    iteration left it."""
    pipe = tpipeline.AlphaZeroPipeline(tiny_run_config(str(tmp_path)),
                                       device="cpu")
    pipe.config.training.replay_checkpoint_interval = 3
    pipe.config.logging.save_best_only = False
    _fake_phases(pipe, monkeypatch, interrupt_at=2)
    pipe.train(num_iterations=2)
    first, last = _saved_buffer(pipe, 1), _saved_buffer(pipe, 2)
    _assert_buffers_equal(last, _buffer(pipe))
    assert first["size"] < last["size"]
    with pytest.raises(KeyboardInterrupt):
        pipe.train(num_iterations=3)  # the third save: not due by count
    _assert_buffers_equal(_saved_buffer(pipe, 2), _buffer(pipe))
    assert _saved_buffer(pipe, 2)["size"] == last["size"] + 8


def test_background_save_holds_the_state_at_save(tmp_path, monkeypatch):
    """With ``background_checkpoint_fetch`` the loop goes on while the
    worker copies: weights, AdamW's state, best weights and buffer written
    in place before the worker runs do not reach the checkpoint."""
    pipe = _trained_pipeline(tmp_path, 2)
    tr = pipe.config.training
    tr.async_checkpointing = tr.background_checkpoint_fetch = True
    before = ckpt.to_host(pipe._checkpoint_tree())
    go, order = threading.Event(), []
    real = ckpt.to_host

    def held(*args, **kwargs):
        assert go.wait(30)
        order.append("copy")
        return real(*args, **kwargs)

    monkeypatch.setattr(ckpt, "to_host", held)
    pipe.save_checkpoint()
    with torch.no_grad():
        for p in [*pipe.learner.net.parameters(),
                  *pipe.best_net.parameters()]:
            p.add_(1.0)
    for st in pipe.learner.state.optimizer.state.values():
        st["exp_avg"].add_(1.0)
    _add_rows(pipe, 3)
    order.append("writes")
    go.set()
    pipe._join_bg_save()
    assert order == ["writes", "copy"]
    got = ckpt.restore_checkpoint(ckpt.latest_checkpoint(
        tr.checkpoint_dir))
    for part in ("learner", "best", "replay"):
        for x, y in zip(_leaves(got[part]), _leaves(before[part])):
            assert torch.equal(x, y) if isinstance(x, torch.Tensor) \
                else x == y, part


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree, key=str) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def test_background_save_error_raised_at_next_join(tmp_path, monkeypatch):
    pipe = _trained_pipeline(tmp_path, 3)
    tr = pipe.config.training
    tr.async_checkpointing = tr.background_checkpoint_fetch = True

    def broken(*args, **kwargs):
        raise OSError("disk full")

    monkeypatch.setattr(ckpt, "save_checkpoint", broken)
    pipe.save_checkpoint()  # the worker fails
    with pytest.raises(OSError, match="disk full"):
        pipe.save_checkpoint()
    pipe._join_bg_save()  # raised once
