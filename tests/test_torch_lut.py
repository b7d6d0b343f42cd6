"""Port parity: quantized ADC lookup tables (repro_torch.kernels.pq_adc.lut)
against repro.kernels.pq_adc.lut on the same numpy inputs."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs in several worker processes at once: one intra-op thread
# each keeps torch's many small CPU ops from contending for the cores
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.kernels.pq_adc import lut as jlut  # noqa: E402
from repro_torch.kernels.pq_adc import lut as tlut  # noqa: E402


def _tables(seed, shape=(12, 8, 64), spread=7.0):
    return (np.random.default_rng(seed).normal(size=shape)
            * spread).astype(np.float32)


def _bits16(a):
    return np.asarray(a).view(np.uint16)


@pytest.mark.parametrize("seed,shape", [(0, (12, 8, 64)), (1, (3, 16, 256)),
                                        (2, (1, 4, 16))])
def test_int8_codes_and_scales_bit_equal(seed, shape):
    t = _tables(seed, shape)
    qj, sj = jlut.quantize_lut(jnp.asarray(t), "int8")
    qt, st = tlut.quantize_lut(torch.from_numpy(t), "int8")
    assert qt.dtype == torch.int8
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy().view(np.uint32),
                                  np.asarray(sj).view(np.uint32))


def test_int8_rounds_half_to_even_with_caller_scale():
    # entries exactly halfway between grid points, with a caller scale of 1
    t = np.array([[[0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, 200.0]]],
                 np.float32)
    scale = np.ones(1, np.float32)
    qj, _ = jlut.quantize_lut(jnp.asarray(t), "int8", jnp.asarray(scale))
    qt, st = tlut.quantize_lut(torch.from_numpy(t), "int8",
                               torch.from_numpy(scale))
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    assert qt.numpy().tolist() == [[[0, 2, 2, 0, -2, -2, 126, 127]]]
    assert st.numpy().tolist() == [1.0]


def test_int8_all_zero_tables_take_the_scale_floor():
    t = np.zeros((2, 4, 8), np.float32)
    qj, sj = jlut.quantize_lut(jnp.asarray(t), "int8")
    qt, st = tlut.quantize_lut(torch.from_numpy(t), "int8")
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    assert (st.numpy() > 0).all()
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))


def test_bf16_tables_bit_equal():
    t = _tables(3)
    qj, _ = jlut.quantize_lut(jnp.asarray(t), "bf16")
    qt, st = tlut.quantize_lut(torch.from_numpy(t), "bf16")
    assert qt.dtype == torch.bfloat16
    np.testing.assert_array_equal(qt.view(torch.int16).numpy().view(np.uint16),
                                  _bits16(np.asarray(qj).view(np.uint16)))
    assert (st.numpy() == 1.0).all()


@pytest.mark.parametrize("lut_dtype", ["f32", "bf16", "int8"])
def test_snap_lut_bit_equal(lut_dtype):
    t = _tables(4)
    fj, sj = jlut.snap_lut(jnp.asarray(t), lut_dtype)
    ft, st = tlut.snap_lut(torch.from_numpy(t), lut_dtype)
    np.testing.assert_array_equal(ft.numpy().view(np.uint32),
                                  np.asarray(fj).view(np.uint32))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))


def test_center_lut_allclose():
    t = _tables(5)
    cj, kj = jlut.center_lut(jnp.asarray(t))
    ct, kt = tlut.center_lut(torch.from_numpy(t))
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=1e-6,
                               atol=1e-5)
    np.testing.assert_allclose(kt.numpy(), np.asarray(kj), rtol=1e-6,
                               atol=1e-5)


@pytest.mark.parametrize("lut_dtype", ["f32", "bf16", "int8"])
def test_lut_error_bound_allclose(lut_dtype):
    t = _tables(6)
    bj = jlut.lut_error_bound(jnp.asarray(t), lut_dtype)
    bt = tlut.lut_error_bound(torch.from_numpy(t), lut_dtype)
    np.testing.assert_allclose(bt.numpy(), np.asarray(bj), rtol=1e-6)


def test_unknown_lut_dtype_raises():
    with pytest.raises(ValueError, match="lut_dtype"):
        tlut.quantize_lut(torch.zeros(1, 1, 2), "fp8")
