"""Parity of the port's dihedral symmetries (``alphazero_reversi_tpu_torch.
symmetry``) with the JAX package's: the tables, and every transform for
each of the 8 symmetries."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphazero_reversi_tpu import symmetry as jsym
from alphazero_reversi_tpu_torch import symmetry as tsym


def test_tables_match_jax():
    np.testing.assert_array_equal(tsym.PERMS, jsym.PERMS)
    np.testing.assert_array_equal(tsym.INVERSE, jsym.INVERSE)
    assert tsym.NUM_SYMS == jsym.NUM_SYMS


@pytest.mark.parametrize("s", range(8))
def test_transforms_match_jax(s):
    rng = np.random.default_rng(s)
    b = 5
    planes = rng.random((b, 8, 8, 3)).astype(np.float32)
    policy = rng.dirichlet(np.ones(65), b).astype(np.float32)
    mask = rng.random((b, 64)) < 0.4
    sym = np.full(b, s, np.int32)
    sym[0] = (s + 3) % 8  # a mixed batch too
    tsym_t, jsym_j = torch.from_numpy(sym), jnp.asarray(sym)
    for tfn, jfn, x in ((tsym.apply_to_planes, jsym.apply_to_planes, planes),
                        (tsym.apply_to_policy, jsym.apply_to_policy, policy),
                        (tsym.apply_to_mask, jsym.apply_to_mask, mask)):
        got = tfn(torch.from_numpy(x), tsym_t).numpy()
        np.testing.assert_array_equal(got, np.asarray(jfn(jnp.asarray(x),
                                                          jsym_j)))
    # the inverse undoes the transform
    back = tsym.apply_to_planes(
        tsym.apply_to_planes(torch.from_numpy(planes), tsym_t),
        torch.from_numpy(tsym.INVERSE[sym]))
    np.testing.assert_array_equal(back.numpy(), planes)


def test_augment_draws_from_the_generator():
    planes = torch.rand(16, 8, 8, 3)
    policy = torch.softmax(torch.randn(16, 65), -1)
    gen = torch.Generator().manual_seed(3)
    got = tsym.augment(gen, planes, policy)
    sym = tsym.random_syms(torch.Generator().manual_seed(3), 16)
    assert sym.dtype == torch.int32 and 0 <= int(sym.min()) <= \
        int(sym.max()) < 8
    want = tsym.augment(None, planes, policy, sym)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
