"""The checks that decide ``correct`` fail where they must: the control (the
reference in float8 in the program's place) reads above the program, and a
run with the timed path broken underneath comes out not correct, for each
fault a cell can have. CPU, tiny sizes; the harness's look for a card is
skipped by calling a kind's ``run`` directly."""
import time
from types import SimpleNamespace

import pytest
import torch

import harness
from kinds import selfplay as sp_kind

CPU = torch.device("cpu")
TINY = dict(num_res_blocks=1, num_filters=16, value_head_hidden_size=16)


def tiny_cell(name, **over):
    c = harness.cell(name)
    cd = c["config_data"]
    cd["model"].update(TINY)
    for k, v in over.items():
        group, key = k.split(".")
        cd[group][key] = v
    return c


def gumbel_cell():
    c = tiny_cell("flagship.selfplay-wide",
                  **{"self_play.num_parallel_games": 24,
                     "mcts.num_simulations": 8,
                     "mcts.max_considered_actions": 4})
    c["traffic_data"].update(check_games=12, search_games=8,
                             moves_per_call=3)
    return c


def puct_cell():
    c = tiny_cell("default.selfplay-leaf16",
                  **{"self_play.num_parallel_games": 12,
                     "mcts.num_simulations": 64, "mcts.max_depth": 6})
    c["traffic_data"].update(check_games=12, search_games=12,
                             moves_per_call=3)
    return c


def sgd_cell(batch=64):
    return tiny_cell("flagship.sgd-b4096",
                     **{"training.batch_size": batch,
                        "training.replay_capacity": 400})


def run_cell(cell, control=False, seed=2 ** 31 + 99):
    torch.manual_seed(0)
    kind = harness.kind_module(cell["traffic_data"]["kind"])
    out = kind.run(cell, seed, 0.3, False, CPU, time.perf_counter(),
                   control=control)
    checks = harness.judge(out["numbers"], cell["limits"])
    return out, harness.passes(checks)


def _search_module(algorithm):
    from alphazero_reversi_tpu_torch.mcts import gumbel, search
    return gumbel if algorithm == "gumbel" else search


@pytest.mark.parametrize("make", [gumbel_cell, puct_cell],
                         ids=["gumbel", "puct"])
def test_selfplay_sound_and_control(make):
    cell = make()
    out, ok = run_cell(cell, control=True)
    assert ok, out["numbers"]
    assert any(v > cell["limits"][k] for k, v in out["control"].items()), \
        out["control"]


@pytest.mark.parametrize("make", [gumbel_cell, puct_cell],
                         ids=["gumbel", "puct"])
def test_selfplay_state_left_unchanged(make, monkeypatch):
    port = sp_kind._port()
    proxy = SimpleNamespace(**{k: getattr(port.env, k)
                               for k in dir(port.env)
                               if not k.startswith("__")})
    proxy.step = lambda states, actions, compat=False: (
        states, torch.ones_like(states.done))
    monkeypatch.setattr(port.selfplay, "env", proxy)
    out, ok = run_cell(make())
    assert not ok and out["numbers"]["env_errors"] > 0


@pytest.mark.parametrize("make,name", [
    (gumbel_cell, "run_gumbel_search"), (puct_cell, "run_search")],
    ids=["gumbel", "puct"])
def test_selfplay_half_the_batch_left_out(make, name, monkeypatch):
    cell = make()
    mod = _search_module(cell["config_data"]["mcts"].get("algorithm", "puct"))
    orig = getattr(mod, name)

    def half(net, states, **kw):
        res = orig(net, states, **kw)
        n = res.visit_counts.shape[0] // 2
        counts = res.visit_counts.clone()
        counts[n:] = 0
        probs = res.action_probs.clone()
        probs[n:] = probs[:n].mean(0)  # the rest's mean for the rest
        return res._replace(visit_counts=counts, action_probs=probs)
    monkeypatch.setattr(mod, name, half)
    out, ok = run_cell(cell)
    assert not ok and (out["numbers"]["search_errors"] > 0
                       or out["numbers"]["policy_sq_error_ratio"] > 3)


def _wrong_c_puct(mod):
    orig = mod._puct_action
    return "_puct_action", lambda v, s, p, lg, c: orig(v, s, p, lg, 4 * c)


def _no_root_noise(mod):
    return "add_dirichlet_noise", lambda prior, legal, *a, **k: prior


def _no_virtual_loss(mod):
    """Root picks within a round that do not see the round's earlier
    picks."""
    orig = mod._puct_action
    state = {}

    def pick(v, s, p, lg, c):
        if v.dim() == 2:  # the root: the round's first pick for every lane
            key = id(p)
            if state.get("key") != key or state.get("n", 0) >= 4:
                state.update(key=key, n=0, v=v, s=s)
            state["n"] += 1
            return orig(state["v"], state["s"], p, lg, c)
        return orig(v, s, p, lg, c)
    return "_puct_action", pick


def _q_sign(mod):
    orig = mod.completed_q_sigma
    return "completed_q_sigma", lambda v, s, *a: orig(v, -s, *a)


def _backup_negated(mod):
    from alphazero_reversi_tpu_torch.mcts import tree
    orig = tree.round_backup

    def neg(t, pn, pa, pt, et, value, *a):
        return orig(t, pn, pa, pt, et, -value, *a)
    return (tree, "round_backup", neg)


@pytest.mark.parametrize("make,fault", [
    (puct_cell, _wrong_c_puct), (puct_cell, _no_root_noise),
    (puct_cell, _no_virtual_loss), (gumbel_cell, _q_sign),
    (gumbel_cell, _backup_negated), (puct_cell, _backup_negated)],
    ids=["puct-c_puct", "puct-root_noise", "puct-virtual_loss",
         "gumbel-q_sign", "gumbel-backup", "puct-backup"])
def test_selfplay_wrong_search(make, fault, monkeypatch):
    """A search whose descent, noise or backup departs from the configured
    one comes out not correct."""
    cell = make()
    if fault is _no_virtual_loss:
        cell["config_data"]["mcts"]["batch_size"] = 4
    mod = _search_module(cell["config_data"]["mcts"].get("algorithm", "puct"))
    planted = fault(mod)
    target, name, fn = planted if len(planted) == 3 else (mod, *planted)
    monkeypatch.setattr(target, name, fn)
    out, ok = run_cell(cell)
    assert not ok and out["numbers"]["policy_sq_error_ratio"] > 3, out


def test_gumbel_answer_altered(monkeypatch):
    mod = _search_module("gumbel")
    orig = mod.run_gumbel_search

    def altered(net, states, **kw):
        res = orig(net, states, **kw)
        legal = sp_kind._port().env.legal_action_mask(states)
        other = torch.where(legal, torch.arange(65), 99).min(-1).values
        bad = torch.where(other != res.chosen_action.long(), other,
                          res.chosen_action.long())
        return res._replace(chosen_action=bad.to(torch.int32))
    monkeypatch.setattr(mod, "run_gumbel_search", altered)
    out, ok = run_cell(gumbel_cell())
    assert not ok and out["numbers"]["move_error_ratio"] > 3


def test_puct_answer_altered(monkeypatch):
    mod = _search_module("puct")
    orig = mod.sample_actions

    def altered(probs, generator=None, noise=None):
        a = orig(probs, generator=generator, noise=noise)
        worst = torch.where(probs > 0, probs, 2.0).argmin(-1).to(torch.int32)
        return torch.where(worst != a, worst, a)
    monkeypatch.setattr(mod, "sample_actions", altered)
    out, ok = run_cell(puct_cell())
    assert not ok and out["numbers"]["search_errors"] > 0


def test_sgd_sound_control_and_faults():
    out, ok = run_cell(sgd_cell(), control=True)
    assert ok, out["numbers"]
    ctl = out["control"]
    limits = harness.cell("flagship.sgd-b4096")["limits"]
    for reading in ctl.values():
        assert not harness.passes(harness.judge(reading, limits)), reading


def test_sgd_state_left_unchanged(monkeypatch):
    monkeypatch.setattr(torch.optim.AdamW, "step",
                        lambda self, closure=None: None)
    out, ok = run_cell(sgd_cell())
    assert not ok and out["numbers"]["change_gap"] == pytest.approx(1.0)


def test_sgd_half_the_batch_left_out(monkeypatch):
    from alphazero_reversi_tpu_torch import learner
    orig = learner.loss_fn

    def half(net, planes, policy_tgt, value_tgt, **kw):
        n = planes.shape[0] // 2
        return orig(net, planes[:n], policy_tgt[:n], value_tgt[:n], **kw)
    monkeypatch.setattr(learner, "loss_fn", half)
    out, ok = run_cell(sgd_cell())
    assert not ok


@pytest.mark.cuda
def test_gumbel_cell_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cell = gumbel_cell()
    kind = harness.kind_module("selfplay")
    out = kind.run(cell, 3, 0.5, True, torch.device("cuda"),
                   time.perf_counter())
    assert harness.passes(harness.judge(out["numbers"], cell["limits"]))
