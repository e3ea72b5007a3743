"""SGD traffic: back-to-back calls of ``Learner.steps`` on one card.

Set-up fills the replay buffer to the configuration's ``replay_capacity``
from the seed: the planes of positions of random legal play (plies drawn
uniformly from ``0 .. max_start_ply``) under the board's 8 symmetries, policy targets that are a softmax of
normal draws over each position's legal moves, values drawn from {-1, 0,
1}. It builds the learner from weights made from the seed and drives it
through the ``checked_calls`` (steps a call: one, then the window's
``steps_per_call``) through the window's own call and feed, a fresh batch
each step, keeping its state before the first step, Adam's first moment
after it and its state after the last; the last of them is the warm-up of
the window's shape. The window runs calls of ``steps_per_call`` steps on the
same learner.

``correct`` holds those first steps against ``reference/sgd.py`` on the
batches a generator seeded alike draws: the first clipped gradient by leaf,
and the change of the parameters and running averages by leaf after all of
them.
"""
from __future__ import annotations

import sys
import time
from types import SimpleNamespace
from typing import Dict

import numpy as np
import torch

import trace as trace_lib
import weights as weights_lib
import yardstick
from reference import rules
from reference import sgd as ref_sgd


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _port():
    from alphazero_reversi_tpu_torch import learner, replay
    from alphazero_reversi_tpu_torch.config import Config
    from alphazero_reversi_tpu_torch.models import resnet
    return SimpleNamespace(learner=learner, replay=replay, Config=Config,
                           resnet=resnet)


def make_data(capacity: int, max_ply: int, seed: int, device):
    """``(planes, policy, value)`` of ``capacity`` training positions."""
    rng = np.random.default_rng(seed)
    games = -(-capacity // 8)
    base = rules.play_random(
        rng.permutation(np.arange(games) % (max_ply + 1)), rng)
    boards = np.concatenate([rules.planes(rules.symmetric(base, k))
                             for k in range(8)])
    planes = torch.as_tensor(boards[rng.permutation(len(boards))[
        :capacity]]).to(device)
    gen = torch.Generator(device=device).manual_seed(seed % 2 ** 63 + 1)
    legal = torch.cat([planes[..., 2].reshape(capacity, 64) > 0,
                       torch.zeros(capacity, 1, dtype=torch.bool,
                                   device=device)], -1)
    legal[:, 64] = ~legal[:, :64].any(-1)
    logits = torch.randn(capacity, 65, generator=gen, device=device)
    policy = torch.softmax(torch.where(legal, logits, -torch.inf), -1)
    value = torch.randint(-1, 2, (capacity,), generator=gen,
                          device=device).float()
    return planes, policy, value


def setup(cell: dict, seed: int, device) -> SimpleNamespace:
    port = _port()
    cfg_data, traffic = cell["config_data"], cell["traffic_data"]
    cfg = port.Config.from_dict(cfg_data)
    tc = cfg.training
    batch = tc.batch_size
    w = weights_lib.make(cfg_data["model"], seed, device)
    net = port.resnet.build_network(cfg.model).to(device)
    missing, unexpected = net.load_state_dict(w, strict=False)
    if unexpected or any(not k.endswith("num_batches_tracked")
                         for k in missing):
        raise RuntimeError(f"weights do not fit the net: {missing} "
                           f"{unexpected}")
    learner = port.learner.Learner(net, tc, device=device)
    del net
    t0 = time.perf_counter()
    data = make_data(tc.replay_capacity, traffic["max_start_ply"], seed,
                     device)
    t_data = time.perf_counter() - t0
    buf = port.replay.add(port.replay.create(tc.replay_capacity,
                                             device=device),
                          *data, torch.ones(tc.replay_capacity,
                                            dtype=torch.bool, device=device))
    gen = torch.Generator(device=device).manual_seed(seed % 2 ** 63)
    tnet = learner.state.net

    def state():
        return {k: v.detach().clone() for k, v in tnet.state_dict().items()
                if not k.endswith("num_batches_tracked")}

    before = state()
    first = None
    for i, steps in enumerate(traffic["checked_calls"]):
        learner.steps(buf, gen, steps, batch)
        if i == 0:
            opt = learner.state.optimizer
            first = {k: opt.state.get(p, {}).get(
                "exp_avg", torch.zeros_like(p)).clone() / (1 - ref_sgd.B1)
                for k, p in tnet.named_parameters()}
    after = state()
    sync(device)
    print(f"set-up: data {t_data:.3f} s, buffer and checked calls "
          f"{time.perf_counter() - t0 - t_data:.3f} s", file=sys.stderr,
          flush=True)
    return SimpleNamespace(port=port, cfg=cfg, cfg_data=cfg_data,
                           learner=learner, buf=buf, gen=gen, batch=batch,
                           weights=w, data=data, before=before, after=after,
                           first=first, traffic=traffic, seed=seed)


def run(cell: dict, seed: int, seconds: float, trace: bool, device,
        t_start: float, control: bool = False) -> Dict:
    st = setup(cell, seed, device)
    steps_per_call = st.traffic["steps_per_call"]
    setup_s = time.perf_counter() - t_start
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    sync(device)
    t0 = time.perf_counter()
    calls, losses = 0, []
    while True:
        aux = st.learner.steps(st.buf, st.gen, steps_per_call, st.batch)
        losses.append(aux["loss"])
        calls += 1
        sync(device)
        if time.perf_counter() - t0 >= seconds:
            break
    window_s = time.perf_counter() - t0
    bad = int((~torch.isfinite(torch.stack(losses))).sum())
    steps = calls * steps_per_call
    out = dict(metrics={"sgd_samples_per_s": steps * st.batch / window_s},
               attempted=steps, failed=bad * steps_per_call,
               window_s=window_s, setup_s=setup_s, units=steps,
               unit="SGD step")
    if device.type == "cuda":
        out["memory_peak_bytes"] = torch.cuda.max_memory_allocated(device)
    if trace:
        n = st.traffic["trace_steps"]
        _, summary = trace_lib.profile(
            lambda: st.learner.steps(st.buf, st.gen, n, st.batch), device)
        out["trace_ctx"] = dict(
            kind="sgd", summary=summary, units=n, unit_wall_s=window_s / steps,
            window_s=window_s, rows_window=steps * st.batch,
            flops_per_row=yardstick.forward_flops(st.cfg_data["model"]))
    st.learner = None  # the program's state goes before the reference runs
    t0 = time.perf_counter()
    out["numbers"] = check(st)
    print(f"check {time.perf_counter() - t0:.3f} s", file=sys.stderr,
          flush=True)
    if control:
        out["control"] = {f: check(st, quant=q, fault=f2) for f, q, f2 in (
            ("fp8", "fp8", None), ("half_batch", None, "half_batch"))}
    return out


def check(st, quant=None, fault=None) -> Dict[str, float]:
    """The first steps against the reference. With ``quant`` or ``fault``
    the reference so computed stands in the program's place (the control
    and the planted faults)."""
    tc = st.cfg.training
    gen = torch.Generator(device=st.data[0].device).manual_seed(
        st.seed % 2 ** 63)
    batches = []
    for _ in range(sum(st.traffic["checked_calls"])):
        idx = torch.randint(0, tc.replay_capacity, (st.batch,),
                            generator=gen, device=gen.device)
        batches.append(tuple(x[idx] for x in st.data))
    kw = dict(model=st.cfg_data["model"], lr=tc.learning_rate,
              weight_decay=tc.weight_decay, max_norm=tc.gradient_clip)
    params0 = {k: v.float() for k, v in st.weights.items()}
    ref = ref_sgd.run(params0, batches, **kw)
    emul = ref_sgd.run(params0, batches[:1], quant="bf16", **kw)
    if quant or fault:
        prog = ref_sgd.run(params0, batches, quant=quant, fault=fault, **kw)
        first, after, before = prog["first_grad"], prog["params"], params0
    else:
        first, after, before = st.first, st.after, st.before
    # leaves whose gradient is nought to rounding move by round-off alone
    raw = ref["raw_grad"]
    floor = torch.tensor([float(g.norm()) for g in raw.values()]).median()
    moving = [k for k in ref["params"]
              if ref_sgd.is_buffer(k) or float(raw[k].norm()) >= 1e-3 * floor]
    change = {k: after[k].float() - before[k].float() for k in moving}
    ref_change = {k: ref["params"][k] - params0[k] for k in moving}
    g_ref = ref["first_grad"]
    return dict(
        # the first clipped gradient's error over what bfloat16 costs
        first_grad_ratio=ref_sgd.error(first, g_ref)
        / ref_sgd.error(emul["first_grad"], g_ref),
        change_gap=float(ref_sgd.leaf_gaps(change, ref_change,
                                           moving).max()))
