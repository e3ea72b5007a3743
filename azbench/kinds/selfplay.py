"""Self-play traffic: back-to-back calls of ``selfplay.play_games``.

Each call plays ``moves_per_call`` move slots of ``games`` games at the
configuration's search settings, from start positions that the benchmark
drew at set-up by random legal play (one game a row, the plies the multiset
``0 .. max_start_ply`` repeated, in an order drawn from the seed; call k
starts from the k-th of ``start_sets`` of the board's symmetries of them),
with every draw made by the benchmark on the device and passed in: the
Gumbel search's ``gumbel_noise``, or PUCT's Dirichlet ``log_gamma`` and
move-sampling ``sample_noise``.

Everything the window and the check read comes from what ``play_games``
returns: the moves are its live (``valid``) game-moves, a search ran in
each slot with a live game, and each search evaluates ``games * (1 +
num_simulations)`` rows (the root, then ``leaf_batch`` leaves a game in each
round). Only the ``--trace 1`` slice after the window adds a benchmark span
(``azbench.net``) around each call of the net's forward, by a hook on the
net object; a forward that runs without calling into Python leaves the span
and the metric that reads it out.

``correct`` replays, for ``check_games`` games drawn from the seed, every
move of every call with the benchmark's rules, holds the recorded policies
and moves to their exact form, and runs the plain search
(``reference/search.py``) from ``search_games`` of them at every live slot
of ``search_calls`` calls drawn from the seed, with the same draws and the
root statistics carried along the moves played, once with the reference
net in float32 and once with its trunk rounded to bfloat16: the program's policies and moves against the float32 search's,
over what the bfloat16 one's depart from it (summed squared policy errors;
moves that differ).
"""
from __future__ import annotations

import sys
import time
from types import SimpleNamespace
from typing import Dict, List

import numpy as np
import torch

import trace as trace_lib
import weights as weights_lib
import yardstick
from reference import net as ref_net
from reference import rules
from reference import search as ref_search

PUCT_TIE = 1e-4  # a score difference float32 rounding cannot reach


def _port():
    from alphazero_reversi_tpu_torch import selfplay
    from alphazero_reversi_tpu_torch.config import Config
    from alphazero_reversi_tpu_torch.env import bitboard as env
    from alphazero_reversi_tpu_torch.models import resnet
    return SimpleNamespace(selfplay=selfplay, Config=Config, env=env,
                           resnet=resnet)


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def to_env(port, s: dict, device):
    t = lambda x, dt: torch.as_tensor(np.ascontiguousarray(x)).to(  # noqa
        device=device, dtype=dt)
    return port.env.EnvState(
        black=t(s["black"].view(np.int64), torch.int64),
        white=t(s["white"].view(np.int64), torch.int64),
        to_move=t(s["to_move"], torch.int32),
        passed=t(s["passed"], torch.int32), done=t(s["done"], torch.bool),
        winner=t(s["winner"], torch.int32))


def log_gamma(alpha: float, shape, gen: torch.Generator, device):
    """``log g``, ``g ~ Gamma(alpha)``, as ``log Gamma(alpha + 1) + log(u) /
    alpha`` (no underflow at small ``alpha``)."""
    a = torch.full(shape, alpha + 1.0, device=device)
    u = torch.rand(shape, generator=gen, device=device).clamp_min(1e-12)
    return torch._standard_gamma(a, generator=gen).log() + u.log() / alpha


def setup(cell: dict, seed: int, device) -> SimpleNamespace:
    """The net from the seed, the start positions and the call; nothing
    run yet."""
    port = _port()
    cfg_data, traffic = cell["config_data"], cell["traffic_data"]
    cfg = port.Config.from_dict(cfg_data)
    games = cfg.self_play.num_parallel_games
    T = traffic["moves_per_call"]
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=device).manual_seed(seed % 2 ** 63)

    w = weights_lib.make(cfg_data["model"], seed, device)
    net = port.resnet.build_network(cfg.model).to(device)
    missing, unexpected = net.load_state_dict(w, strict=False)
    if unexpected or any(not k.endswith("num_batches_tracked")
                         for k in missing):
        raise RuntimeError(f"weights do not fit the net: {missing} "
                           f"{unexpected}")

    t0 = time.perf_counter()
    plies = rng.permutation(np.arange(games) % (traffic["max_start_ply"]
                                                 + 1))
    base = rules.play_random(plies, rng)
    print(f"set-up: start positions {time.perf_counter() - t0:.3f} s",
          file=sys.stderr, flush=True)
    starts = [rules.symmetric(base, int(k))
              for k in rng.permutation(8)[:traffic["start_sets"]]]
    n_check = min(traffic["check_games"], games)
    rows_np = np.sort(rng.choice(games, n_check, replace=False))
    rows = torch.as_tensor(rows_np, device=device)
    searched = np.sort(rng.choice(n_check, min(traffic["search_games"],
                                               n_check), replace=False))

    kw = port.selfplay.search_kwargs(cfg.mcts, cfg.self_play,
                                     cfg.env_compat)
    gumbel = kw["algorithm"] == "gumbel"
    searches = torch.zeros((), dtype=torch.int64, device=device)
    kept: List[dict] = []

    def draw(moves: int):
        shape = (moves, games, 65)
        if gumbel:
            g = torch.empty(shape, device=device).exponential_(
                generator=gen).log_().neg_()
            return dict(gumbel_noise=g)
        return dict(log_gamma=log_gamma(kw["dirichlet_alpha"], shape, gen,
                                        device),
                    sample_noise=torch.empty(shape, device=device)
                    .exponential_(generator=gen).log_().neg_())

    def call(k: int, moves: int, keep: bool):
        """Call ``k`` of ``moves`` slots: its live game-moves (on the
        device); ``searches`` counts the slots that searched. With ``keep``
        the checked games' records are kept."""
        nonlocal searches
        start = starts[k % len(starts)]
        states = to_env(port, start, device)
        noise = draw(moves)
        traj = port.selfplay.play_games(
            net, num_games=games, init_states=states, generator=gen,
            device=device, **dict(kw, max_moves=moves), **noise)
        searches = searches + traj.valid.any(-1).sum()
        if keep:
            r = rows
            fs = traj.final_state
            kept.append(dict(
                start={k2: v[rows_np] for k2, v in start.items()},
                planes=traj.planes[:, r], policy=traj.policy[:, r],
                value=traj.value[:, r], to_move=traj.to_move[:, r],
                valid=traj.valid[:, r], actions=traj.actions[:, r],
                final={f: getattr(fs, f)[r] for f in fs._fields},
                noise={n: v[:, r] for n, v in noise.items()}))
        return traj.valid.sum()

    st = SimpleNamespace(port=port, cfg=cfg, cfg_data=cfg_data, kw=kw,
                         gumbel=gumbel, T=T, games=games, net=net,
                         weights=w, call=call, kept=kept, traffic=traffic,
                         searched=searched, rng=rng,
                         rows_per_search=games * (1 + kw["num_simulations"]))
    st.searches = lambda: int(searches)
    return st


def run(cell: dict, seed: int, seconds: float, trace: bool, device,
        t_start: float, control: bool = False) -> Dict:
    st = setup(cell, seed, device)
    st.call(0, 1, keep=False)  # warm-up at the cell's shapes
    sync(device)
    setup_s = time.perf_counter() - t_start

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    s0 = st.searches()
    moves = torch.zeros((), dtype=torch.int64, device=device)
    sync(device)
    t0 = time.perf_counter()
    k = 0
    while True:
        moves += st.call(k, st.T, keep=True)
        k += 1
        sync(device)
        if time.perf_counter() - t0 >= seconds:
            break
    window_s = time.perf_counter() - t0
    slots = st.searches() - s0
    moves_done = int(moves)
    st.search_calls = set(st.rng.choice(
        k, min(st.traffic["search_calls"], k), replace=False).tolist())

    out = dict(metrics={"selfplay_moves_per_s": moves_done / window_s},
               attempted=k, window_s=window_s, setup_s=setup_s,
               units=slots, unit="move slot")
    if device.type == "cuda":
        out["memory_peak_bytes"] = torch.cuda.max_memory_allocated(device)
    if trace:
        out["trace_ctx"] = _traced_slice(st, device, k, window_s, slots)
    st.net = st.call = None  # the program's state goes before the check
    t0 = time.perf_counter()
    numbers = check(st, control=False)
    print(f"check {time.perf_counter() - t0:.3f} s", file=sys.stderr,
          flush=True)
    out["numbers"] = numbers
    out["failed"] = numbers.pop("calls_with_errors")
    if control:
        out["control"] = check(st, control=True, ratios_only=True)
    return out


def _traced_slice(st, device, k, window_s, slots) -> dict:
    """A profiled call of ``trace_slots`` slots after the window, with a
    span around each forward of the net."""
    span = []

    def pre(module, inputs):
        span.append(torch.profiler.record_function("azbench.net"))
        span[-1].__enter__()

    def post(module, inputs, out):
        span.pop().__exit__(None, None, None)
    hooks = [st.net.register_forward_pre_hook(pre),
             st.net.register_forward_hook(post)]
    s0 = st.searches()
    n = st.traffic["trace_slots"]
    try:
        _, summary = trace_lib.profile(lambda: st.call(k, n, keep=False),
                                       device)
    finally:
        for h in hooks:
            h.remove()
    units = st.searches() - s0
    kw = st.kw
    bound_s = units * yardstick.search_backup_bytes(
        st.games, kw["num_simulations"], kw["leaf_batch"], kw["max_depth"],
        kw["num_stages"]) / yardstick.PEAK_BYTES_PER_S
    return dict(kind="selfplay", summary=summary, units=units,
                unit_wall_s=window_s / slots, window_s=window_s,
                rows_window=slots * st.rows_per_search,
                rows_slice=units * st.rows_per_search,
                flops_per_row=yardstick.forward_flops(st.cfg_data["model"]),
                backup_bound_s=bound_s, backup_kernel="round_backup_link")


def _net(params, model, dev, quant):
    """The reference net at ``quant`` as a function of host planes."""
    def fn(planes: np.ndarray):
        with torch.no_grad(), ref_net.exact_matmul():
            lg, val, _ = ref_net.forward(
                params, torch.as_tensor(planes).to(dev),
                model["num_res_blocks"], quant=quant)
        return lg.cpu(), val.cpu()
    return fn


def _host(x):
    if isinstance(x, dict):
        return {k: _host(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_host(v) for v in x)
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    return x


def _replay(call: dict, T: int):
    """The env's errors in one kept call, and per slot the states, legal
    moves and live games that the benchmark's rules give."""
    errors = 0
    s = call["start"]
    states, legal_ref, live_ref = [], [], []
    for t in range(T):
        live = ~s["done"]
        valid = call["valid"][t].numpy()
        act = call["actions"][t].numpy().astype(np.int64)
        legal = rules.legal_mask(s)
        bad = valid != live
        bad |= live & (np.abs(call["planes"][t].numpy() - rules.planes(s))
                       .reshape(len(act), -1).max(-1) > 0)
        bad |= live & (call["to_move"][t].numpy() != s["to_move"])
        ok_act = legal[np.arange(len(act)), np.clip(act, 0, 64)] & (act >= 0)
        bad |= live & ~ok_act
        bad |= ~live & (act != -1)
        errors += int(bad.sum())
        states.append(s)
        legal_ref.append(legal)
        live_ref.append(live)
        moved = rules.step(s, np.where(live & ok_act, act, 64))
        s = {k: np.where(live & ok_act, moved[k], s[k]) for k in s}
    fin = call["final"]
    for f in ("black", "white"):
        errors += int((fin[f].numpy().view(np.uint64) != s[f]).sum())
    for f in ("to_move", "passed", "done", "winner"):
        errors += int((fin[f].numpy().astype(np.int64)
                       != s[f].astype(np.int64)).sum())
    want_v = np.stack([np.where(live_ref[t], rules.outcome(
        s, call["to_move"][t].numpy()), 0.0) for t in range(T)])
    errors += int((call["value"].numpy() != want_v).sum())
    return errors, states, np.stack(legal_ref), np.stack(live_ref)


def _form_errors(st, call: dict, t: int, legal, live) -> int:
    """Live games whose recorded policy or move is not of the search's
    exact form: a distribution over the legal moves; for PUCT, visit counts
    over their sum and the move the benchmark's noise samples from them at
    the slot's temperature."""
    policy = call["policy"][t].double()
    lgl = torch.as_tensor(legal)
    lv = torch.as_tensor(live)
    bad = torch.where(lgl, 0.0, policy).abs().sum(-1) > 0
    if st.gumbel:
        bad |= (policy.sum(-1) - 1.0).abs() > 1e-4
        return int((lv & bad).sum())
    sims = st.kw["num_simulations"]
    counts = policy * sims
    whole = counts.round()
    bad |= ((counts - whole).abs() > 1e-3).any(-1)
    bad |= whole.sum(-1) != sims
    temp = st.kw["temp_init"] if t < st.kw["temp_threshold"] \
        else st.kw["temp_final"]
    gap = ref_search.move_gap(
        ref_search.puct_sample_score(whole, temp,
                                     call["noise"]["sample_noise"][t]),
        whole > 0, call["actions"][t].long())
    bad |= gap > PUCT_TIE
    return int((lv & bad).sum())


def check(st, control: bool, ratios_only: bool = False) -> Dict[str, float]:
    """The compared numbers over every kept call. ``control``: the
    reference search with its trunk in float8 stands in for the program's
    policies and moves."""
    kw = st.kw
    T = st.T
    kept = _host(st.kept)
    params = {k: v.detach().float() for k, v in st.weights.items()}
    dev = next(iter(params.values())).device
    model = st.cfg_data["model"]
    nets = {"f32": _net(params, model, dev, None),
            "bf16": _net(params, model, dev, "bf16")}
    if control:
        nets["fp8"] = _net(params, model, dev, "fp8")
    search_kw = dict(
        algorithm=kw["algorithm"], simulations=kw["num_simulations"],
        leaf_batch=kw["leaf_batch"], max_depth=kw["max_depth"],
        stages=kw["num_stages"], c_puct=kw["c_puct"],
        dirichlet_epsilon=kw["dirichlet_epsilon"],
        max_considered=kw["max_considered_actions"], c_visit=kw["c_visit"],
        c_scale=kw["c_scale"], warm_discount=kw["tree_reuse_discount"])
    reuse = kw["tree_reuse"] == "root"
    n = dict(env_errors=0, search_errors=0, calls_with_errors=0)
    subject = "fp8" if control else "program"  # what is judged
    sq = {subject: 0.0, "bf16": 0.0}  # squared policy errors against f32
    miss = {subject: 0, "bf16": 0}  # moves other than the f32 search's
    idx = st.searched
    for c, call in enumerate(kept):
        errors, states, legal, live = _replay(call, T)
        form = sum(_form_errors(st, call, t, legal[t], live[t])
                   for t in range(T))
        n["env_errors"] += errors
        n["search_errors"] += form
        n["calls_with_errors"] += int(errors + form > 0)
        if c not in st.search_calls:
            continue
        warm = {v: (torch.zeros(len(idx), 65), torch.zeros(len(idx), 65))
                for v in nets}
        for t in range(T):
            lv = torch.as_tensor(live[t][idx])
            if not lv.any():
                break
            rows = torch.as_tensor(idx)[lv]
            root = {k: v[rows.numpy()] for k, v in states[t].items()}
            noise = {k: v[t][rows] for k, v in call["noise"].items()}
            played = call["actions"][t][rows].long()
            got = dict(program=dict(policy=call["policy"][t][rows],
                                    move=played))
            for v, fn in nets.items():
                got[v] = ref_search.run(
                    fn, root, gumbel=noise.get("gumbel_noise"),
                    log_gamma=noise.get("log_gamma"),
                    warm=tuple(w[lv] for w in warm[v]) if reuse else None,
                    **search_kw)
                nxt = ref_search.warm_after(got[v]["tree"], played)
                warm[v] = tuple(torch.zeros_like(w).index_put_(
                    (lv.nonzero()[:, 0],), x) for w, x in zip(warm[v], nxt))
                got[v].pop("tree")
            ref = got["f32"]
            for v in sq:
                sq[v] += float((got[v]["policy"].double()
                                - ref["policy"].double()).pow(2).sum())
                if st.gumbel:
                    miss[v] += int((got[v]["move"].long()
                                    != ref["move"].long()).sum())
    # the program's departures from the float32 search over bfloat16's
    n["policy_sq_error_ratio"] = sq[subject] / max(sq["bf16"], 1e-300)
    if st.gumbel:  # one added to both counts, which may be 0
        n["move_error_ratio"] = (miss[subject] + 1) / (miss["bf16"] + 1)
    if ratios_only:
        return {k: v for k, v in n.items() if k.endswith("_ratio")}
    return n
