"""PyTorch port, the copy kernel's chain vs the JAX Pallas ``chain_copy``.

``copy_kernel`` and ``chain_copy`` are local to ``main()`` of
``benchmarks/micro_erwin_fused.py`` (``:70-80``) and cannot be imported, so
``_jax_chain_copy`` below re-creates those lines as they stand, with
``interpret=True`` so that the Pallas kernel runs on the CPU. The port's
``chain_copy`` runs the plain version on CPU tensors. Tolerance: none, the
same float32 multiply by float32(1.000001) gives the same bits.
"""

import jax
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from haet_torch.ops.kernels import copy_kernel as ck
from haet_torch.ops.kernels import launch_counts, reset_launch_counts


def _jax_chain_copy(x2d, reps):
    """``micro_erwin_fused.py:70-80``, with ``interpret=True``."""
    def copy_kernel(x_ref, o_ref):
        o_ref[...] = x_ref[...] * 1.000001

    f = pl.pallas_call(
        copy_kernel,
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct(x2d.shape, x2d.dtype),
        interpret=True,
    )
    return jax.lax.fori_loop(0, reps, lambda i, v: f(v), x2d)


@pytest.fixture(scope="module")
def jax_chain():
    """One compile for every ``reps`` (a traced loop bound)."""
    return jax.jit(_jax_chain_copy)


@pytest.fixture(scope="module")
def x():
    rng = np.random.RandomState(0)
    return rng.randn(256, 32).astype(np.float32)   # the micro driver's rows


@pytest.mark.parametrize("reps", [1, 3, 50])
def test_chain_copy_matches_jax_bit_for_bit(jax_chain, x, reps):
    want = np.asarray(jax_chain(x, reps))
    got = ck.chain_copy(torch.from_numpy(x), reps).numpy()
    print(f"PARITY chain_copy reps {reps}: max_abs_err "
          f"{np.abs(got - want).max():.3e}")
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got, x)   # the multiply did happen


def test_cpu_wrapper_runs_plain_and_counts_no_launch(x):
    reset_launch_counts()
    xt = torch.from_numpy(x)
    out = ck.copy_scale(xt)
    assert out.data_ptr() != xt.data_ptr()     # a new tensor, as out_shape
    torch.testing.assert_close(out, ck.copy_scale_plain(xt), rtol=0, atol=0)
    ck.chain_copy(xt, 4)
    assert launch_counts()["copy_scale"] == 0
    assert ck.LAUNCHES.value == 0


def test_wrapper_refuses_other_devices():
    with pytest.raises(ValueError, match="cuda or cpu"):
        ck.copy_scale(torch.empty(4, device="meta"))
