"""The Pallas SGM kernel (ops/sgm_triton.py) against the plain reference.

On the CPU the kernel runs through the Pallas interpreter; it must be
bit-identical to ``ops.sgm.sgm_aggregate`` (whole-number costs and
penalties, and the same float32 operations in the same order). The
``gpu``-marked tests run the compiled kernel on a card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from i3dr_stereo_tpu.ops.sgm import (BIG, DIRECTIONS_4, DIRECTIONS_5,
                                     DIRECTIONS_8, sgm_aggregate)
from i3dr_stereo_tpu.ops.sgm_triton import sgm_aggregate_triton
from i3dr_stereo_tpu.utils.smoke import census_like_costs, sgm_parity


def _costs(shape, seed=0):
    rng = np.random.default_rng(seed)
    return jnp.asarray(rng.integers(0, 40, shape).astype(np.float32))


def _both(C, *args, **kw):
    ref = np.asarray(sgm_aggregate(C, *args, **kw))
    ker = np.asarray(sgm_aggregate_triton(C, *args, interpret=True, **kw))
    return ref, ker


@pytest.mark.parametrize("direction", DIRECTIONS_8)
def test_single_direction_bit_exact(direction):
    C = _costs((1, 7, 9, 8), seed=1)
    ref, ker = _both(C, 3.0, 20.0, (direction,))
    np.testing.assert_array_equal(ker, ref)


@pytest.mark.parametrize("dirs", [DIRECTIONS_4, DIRECTIONS_5, DIRECTIONS_8],
                         ids=["4paths", "5paths", "8paths"])
def test_direction_sets_bit_exact(dirs):
    C = _costs((1, 8, 10, 8), seed=2)
    ref, ker = _both(C, 4.0, 30.0, dirs)
    np.testing.assert_array_equal(ker, ref)


def test_per_direction_penalties():
    C = _costs((1, 9, 11, 8), seed=3)
    pens = tuple((float(i + 1), float(10 * i + 15)) for i in range(8))
    ref, ker = _both(C, directions=DIRECTIONS_8, per_direction_penalties=pens)
    np.testing.assert_array_equal(ker, ref)


@pytest.mark.parametrize("D", [5, 8, 20, 32, 128])
def test_disparity_widths_and_padding(D):
    """D that is not a power of two is padded inside the kernel by
    masking; the sum over the real D is unchanged."""
    C = _costs((1, 5, 6, D), seed=D)
    ref, ker = _both(C, 3.0, 25.0, DIRECTIONS_4)
    assert ker.shape == (1, 5, 6, D)
    np.testing.assert_array_equal(ker, ref)


def test_odd_height_and_width():
    C = _costs((1, 11, 13, 8), seed=4)
    ref, ker = _both(C, 2.0, 15.0, DIRECTIONS_8)
    np.testing.assert_array_equal(ker, ref)


def test_batch_of_two():
    C = _costs((2, 6, 7, 8), seed=5)
    ref, ker = _both(C, 3.0, 20.0, DIRECTIONS_8)
    np.testing.assert_array_equal(ker, ref)
    solo = np.asarray(sgm_aggregate_triton(C[1], 3.0, 20.0, DIRECTIONS_8,
                                           interpret=True))
    np.testing.assert_array_equal(solo, ker[1])


def test_unbatched_input():
    C = _costs((6, 7, 8), seed=6)
    ref, ker = _both(C, 3.0, 20.0, DIRECTIONS_4)
    assert ker.shape == (6, 7, 8)
    np.testing.assert_array_equal(ker, ref)


def test_big_cost_propagation():
    """BIG entries (window outside the image) and whole BIG columns
    propagate through the recurrence exactly as in the reference."""
    C = np.asarray(census_like_costs((1, 6, 12, 8), seed=7)).copy()
    C[0, :, 9, :] = BIG          # a column with no valid disparity
    C[0, 3, :, 2] = BIG
    C = jnp.asarray(C)
    ref, ker = _both(C, 5.0, 40.0, DIRECTIONS_8)
    assert (ref > BIG / 2).any()
    np.testing.assert_array_equal(ker, ref)


def test_fractional_penalties():
    C = _costs((1, 6, 8, 8), seed=8)
    pens = ((2.5, 17.25),) * 4
    ref, ker = _both(C, directions=DIRECTIONS_4, per_direction_penalties=pens)
    np.testing.assert_allclose(ker, ref, rtol=1e-6, atol=0)


def test_traced_penalties_do_not_retrace():
    """Penalties are runtime operands: new values reuse the compiled
    program (live reconfigure must not recompile)."""
    traces = []

    @jax.jit
    def agg(C, p1, p2):
        traces.append(1)
        return sgm_aggregate_triton(C, p1, p2, DIRECTIONS_4, interpret=True)

    C = _costs((1, 5, 6, 8), seed=9)
    for p1, p2 in ((3.0, 20.0), (5.0, 44.0)):
        out = np.asarray(agg(C, jnp.float32(p1), jnp.float32(p2)))
        ref = np.asarray(sgm_aggregate(C, p1, p2, DIRECTIONS_4))
        np.testing.assert_array_equal(out, ref)
    assert len(traces) == 1


@pytest.mark.parametrize("shape", [(1, 1, 9, 8), (1, 9, 1, 8), (1, 2, 3, 5)],
                         ids=["one_row", "one_column", "two_rows"])
def test_degenerate_shapes(shape):
    """A single row or column: every diagonal line is one pixel long and
    some directions take one step."""
    C = _costs(shape, seed=10)
    ref, ker = _both(C, 3.0, 20.0, DIRECTIONS_8)
    np.testing.assert_array_equal(ker, ref)


def test_smoke_parity_helper_in_interpreter():
    """The check chip_smoke.py runs at real widths, at a small one."""
    r = sgm_parity((1, 8, 12, 8), DIRECTIONS_4, ((7.0, 60.0),) * 4,
                   interpret=True)
    assert r["bit_exact"] and r["max_abs"] == 0.0


@pytest.mark.gpu
@pytest.mark.parametrize("shape,dirs", [((1, 256, 320, 32), DIRECTIONS_4),
                                        ((2, 128, 160, 128), DIRECTIONS_8)],
                         ids=["4paths_d32", "8paths_d128_batch2"])
def test_compiled_kernel_bit_exact_on_gpu(gpu, shape, dirs):
    r = sgm_parity(shape, dirs, ((8.0, 64.0),) * len(dirs))
    assert r["bit_exact"], r
