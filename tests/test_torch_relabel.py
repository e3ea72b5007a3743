"""Parity of the port's exact-value relabel and trajectory persistence
(``alphazero_reversi_tpu_torch.selfplay``) with the JAX package's, on a
tiny trajectory that the port's self-play plays from late positions."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphazero_reversi_tpu import selfplay as jselfplay
from alphazero_reversi_tpu_torch import selfplay as tselfplay
from torch_parity import make_nets, random_positions, to_jax_state

B, T, MAX_EMPTIES = 8, 16, 12
KW = dict(num_simulations=4, c_puct=1.0, dirichlet_alpha=0.3,
          dirichlet_epsilon=0.25, temp_threshold=2, temp_init=1.0,
          temp_final=0.1, max_depth=4, max_moves=T, num_stages=1,
          algorithm="gumbel", max_considered_actions=4, tree_reuse="root")


@pytest.fixture(scope="module")
def trajs():
    """The port's trajectory and the same arrays as a JAX Trajectory."""
    _, _, tnet, _ = make_nets(4, 1, 8)
    init = random_positions(B, 11, plies=np.arange(44, 44 + B))
    gen = torch.Generator().manual_seed(0)
    ttraj = tselfplay.play_games(tnet, num_games=B, init_states=init,
                                 generator=gen, device="cpu", **KW)
    j = lambda x: jnp.asarray(x.numpy())
    jtraj = jselfplay.Trajectory(
        planes=j(ttraj.planes), policy=j(ttraj.policy), value=j(ttraj.value),
        to_move=j(ttraj.to_move), valid=j(ttraj.valid),
        final_state=to_jax_state(ttraj.final_state),
        actions=j(ttraj.actions))
    return ttraj, jtraj


def _without_seconds(stats):
    return {k: v for k, v in stats.items() if k != "seconds"}


def test_pack_stone_boards_matches_jax(trajs):
    ttraj, jtraj = trajs
    mine, theirs = tselfplay.pack_stone_boards(ttraj.planes)
    assert mine.dtype == theirs.dtype == torch.int64
    assert mine.shape == theirs.shape == (T, B)
    mhi, mlo, thi, tlo = (np.asarray(x) for x in
                          jselfplay.pack_stone_boards(jtraj.planes))
    combine = jselfplay._combine_u64_np
    np.testing.assert_array_equal(mine.numpy().view(np.uint64),
                                  combine(mhi, mlo))
    np.testing.assert_array_equal(theirs.numpy().view(np.uint64),
                                  combine(thi, tlo))


def test_popcount_matches_jax():
    x = np.random.default_rng(0).integers(0, 2 ** 63, 64, dtype=np.uint64) \
        * np.uint64(2)
    np.testing.assert_array_equal(tselfplay._popcount64_np(x),
                                  jselfplay._popcount64_np(x))


@pytest.mark.parametrize("budget", [None, 0.0], ids=["unlimited", "zero"])
@pytest.mark.parametrize("entry", ["packed", "planes"])
def test_relabel_host_core_matches_jax(trajs, entry, budget):
    """Values exactly equal, stats equal except ``seconds``; budget 0.0
    solves nothing and keeps every label."""
    ttraj, _ = trajs
    planes, to_move, valid, value = (
        x.numpy() for x in (ttraj.planes, ttraj.to_move, ttraj.valid,
                            ttraj.value))
    kw = dict(max_empties=MAX_EMPTIES, budget_s=budget)
    if entry == "packed":
        mine, theirs = (x.numpy().view(np.uint64)
                        for x in tselfplay.pack_stone_boards(ttraj.planes))
        got = tselfplay.relabel_packed_np(mine, theirs, to_move, valid,
                                          value, **kw)
        want = jselfplay.relabel_packed_np(mine, theirs, to_move, valid,
                                           value, **kw)
    else:
        got = tselfplay.relabel_np(planes, to_move, valid, value, **kw)
        want = jselfplay.relabel_np(planes, to_move, valid, value, **kw)
    np.testing.assert_array_equal(got[0], want[0])
    assert _without_seconds(got[1]) == _without_seconds(want[1])
    assert got[1]["candidates"] > 0
    if budget is None:
        assert got[1]["solved"] == got[1]["candidates"]
    else:
        assert got[1]["solved"] == 0
        np.testing.assert_array_equal(got[0], value)


def test_relabel_exact_values_with_stats_matches_jax(trajs):
    ttraj, jtraj = trajs
    tout, tstats = tselfplay.relabel_exact_values_with_stats(
        ttraj, MAX_EMPTIES)
    jout, jstats = jselfplay.relabel_exact_values_with_stats(
        jtraj, MAX_EMPTIES)
    assert _without_seconds(tstats) == _without_seconds(jstats)
    assert tstats["solved"] > 0
    assert tout.value.device == ttraj.value.device
    np.testing.assert_array_equal(tout.value.numpy(), np.asarray(jout.value))
    assert set(np.unique(tout.value.numpy())) <= {-1.0, 0.0, 1.0}
    assert torch.equal(tout.planes, ttraj.planes)
    np.testing.assert_array_equal(
        tselfplay.relabel_exact_values(ttraj, MAX_EMPTIES).value.numpy(),
        tout.value.numpy())


def test_saved_trajectory_loads_in_both_packages(trajs, tmp_path):
    """A file the port writes loads in JAX, and a JAX file in the port;
    both give the trajectory's arrays."""
    ttraj, jtraj = trajs
    port_file = tselfplay.save_trajectory(ttraj, str(tmp_path), "port")
    jax_file = jselfplay.save_trajectory(jtraj, str(tmp_path), "jax")
    assert port_file.endswith("selfplay_port.npz")
    from_port = jselfplay.load_trajectory_arrays(port_file)
    from_jax = tselfplay.load_trajectory_arrays(jax_file)
    assert from_port.keys() == from_jax.keys()
    for name, arr in from_port.items():
        np.testing.assert_array_equal(arr, from_jax[name], err_msg=name)
        assert arr.dtype == from_jax[name].dtype, name
        np.testing.assert_array_equal(arr, getattr(ttraj, name).numpy(),
                                      err_msg=name)
