"""Operations and bytes from shapes, worked by hand, and the reading of a
profiler trace."""

import pytest

from benchmark import roofline
from benchmark.harness.readers import sequence_flops
from benchmark.harness.trace import parse
from benchmark.reference.bert import Arch

E5 = Arch(384, 12, 12, 1536, 30522, 512, 2, 1e-12, 0, "bert", 0.1, 0.1)


def test_dense_flops_per_token():
    # 4 projections of 384 x 384 and 384 x 1536 twice, 2 FLOPs a multiply-add
    assert roofline.dense_flops_per_token(384, 1536, 12) == 12 * 2 * (4 * 147456 + 2 * 589824)
    assert roofline.dense_flops_per_token(384, 1536, 12) == 42467328


def test_encoder_flops_of_one_sequence():
    # 100 tokens: dense 100 x 42,467,328; scores and weighted sum 4 x 100^2 x 384 a layer
    assert roofline.encoder_flops(100, 384, 1536, 12) == 100 * 42467328 + 12 * 4 * 10000 * 384
    assert sequence_flops([100], E5, False) == roofline.encoder_flops(100, 384, 1536, 12)
    assert sequence_flops([100, 100], E5, True) == (2 * roofline.encoder_flops(100, 384, 1536, 12)
                                                    + 2 * 2 * 384 * 385)


def test_sweep_of_msmarco():
    n_bytes, ops = roofline.sweep_work(8_841_823, 384, 64)
    assert n_bytes == 8_841_823 * 388
    assert ops == 2 * 64 * 8_841_823 * 384
    # bytes bind: 3.43 GB at 3.35 TB/s is 1.024 ms, the int8 products 0.22 ms
    assert roofline.bound_s(n_bytes, ops, "int8") == pytest.approx(8_841_823 * 388 / 3.35e12)


def test_attention_work():
    # [256 x 12 heads, 512, 32] bf16: q, k, v, o of 2 bytes, the mask in f32
    n_bytes, ops = roofline.attention_fwd_work(3072, 512, 32, "bfloat16")
    assert n_bytes == 4 * 3072 * 512 * 32 * 2 + 3072 * 512 * 4
    assert ops == 4 * 3072 * 512 * 512 * 32
    b_bytes, b_ops = roofline.attention_bwd_work(3072, 512, 32, "bfloat16")
    assert b_ops == 2.5 * ops and b_bytes == 7 * 3072 * 512 * 32 * 2 + 2 * 3072 * 512 * 4


def test_gemm_flops_count_padding():
    assert roofline.gemm_flops(256, 512, 384, 1536, 12) == 256 * 512 * 42467328


def test_peaks():
    assert roofline.PEAK_OPS == {"bfloat16": 989e12, "float32": 495e12, "int8": 1979e12}
    assert roofline.HBM_BYTES_PER_S == 3.35e12


def _x(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def test_parse_attributes_kernels_and_gaps():
    events = [
        _x("user_annotation", "bench.trace_window", 0, 1000),
        _x("user_annotation", "bench.forward B=4 L=16", 10, 100),
        _x("cpu_op", "aten::linear", 20, 10),
        _x("cuda_runtime", "cudaLaunchKernel", 22, 2, corr=1),
        _x("cuda_runtime", "cudaLaunchKernel", 60, 2, corr=2),
        _x("user_annotation", "bench.topk", 200, 50),
        _x("cuda_runtime", "cudaLaunchKernel", 210, 2, corr=3),
        _x("kernel", "gemm_kernel", 100, 100, tid=7, corr=1),
        _x("kernel", "softmax_kernel", 150, 100, tid=7, corr=2),
        _x("kernel", "binmax_tc_kernel", 600, 100, tid=7, corr=3),
    ]
    t = parse(events)
    assert t.window_s == pytest.approx(1e-3)
    assert t.busy_s == pytest.approx(250e-6)  # 100-250 and 600-700
    gemm, soft, sweep = t.ops
    assert gemm.ranges == ("bench.forward B=4 L=16",) and "aten::linear" in gemm.ops
    assert soft.ranges == ("bench.forward B=4 L=16",) and "aten::linear" not in soft.ops
    assert sweep.ranges == ("bench.topk",)
    # idle 0-100 inside the forward's range, 250-600 and 700-1000 outside any
    idle = dict((label, s) for label, s in t.breakdown()["idle_gaps"])
    assert idle == pytest.approx({"bench.forward": 100e-6, "no benchmark range": 650e-6})
    assert t.breakdown()["device_ops"][0][1] == pytest.approx(1e-4)
