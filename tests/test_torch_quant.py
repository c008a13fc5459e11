"""Port vs JAX: int8 and packed-int4 row quantization must be bit-exact
(both round half to even, and every step is one IEEE f32 operation)."""

import numpy as np
import pytest
import torch

from sskd_tpu.ops import quant as jq
from sskd_tpu_torch.ops import quant as tq


def _rows(seed, n=257, d=64):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    x[0] = 0.0  # all-zero row: the 1e-9 absmax floor
    x[1, :] = 0.5 * np.arange(d, dtype=np.float32)  # exact .5 ties after scaling
    return x


@pytest.mark.parametrize("seed", [0, 1])
def test_int8_bit_exact(seed):
    x = _rows(seed)
    jv, js = jq.quantize_rows(x)
    tv, ts = tq.quantize_rows(torch.from_numpy(x))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        tq.dequantize_rows(tv, ts).numpy(), np.asarray(jq.dequantize_rows(jv, js))
    )


@pytest.mark.parametrize("seed", [0, 1])
def test_int4_bit_exact(seed):
    x = _rows(seed)
    jp, js = jq.quantize_rows_int4(x)
    tp, ts = tq.quantize_rows_int4(torch.from_numpy(x))
    assert tp.dtype == torch.uint8 and tp.shape == (x.shape[0], x.shape[1] // 2)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tq.unpack_int4(tp).numpy(), np.asarray(jq.unpack_int4(jp)))
    np.testing.assert_array_equal(
        tq.dequantize_rows_int4(tp, ts).numpy(),
        np.asarray(jq.dequantize_rows_int4(jp, js)),
    )


def test_int4_rejects_odd_dim():
    with pytest.raises(ValueError):
        tq.quantize_rows_int4(torch.zeros(2, 5))
