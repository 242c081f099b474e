"""The train step's cuBLAS products by hand arithmetic, and the cuBLAS role
table, which takes no kernel of the port and leaves every other table's
roles as they were."""

import json
import os

import pytest

from xvbench import gemm_work, harness, trace, work

PORT_KERNELS = [
    "void fwd_sm90_kernel<0>(CUtensorMap_st, CUtensorMap_st)",
    "void (anonymous namespace)::fwd_sm90_kernel<1>(CUtensorMap_st)",
    "void fwd_sm90_kernel<2>(CUtensorMap_st)",
    "void tdnn_l0_sm90_kernel<1>(CUtensorMap_st)",
    "void dw_sm90_kernel<256>(CUtensorMap_st)",
    "(anonymous namespace)::dx_sm90_kernel(CUtensorMap_st, CUtensorMap_st)",
    "void (anonymous namespace)::sliding_cmvn_kernel<false>(float const*)",
    "void tdnn_layer_kernel<1>(LayerArgs)",
    "shift_gemm_kernel(ShiftArgs)",
    "dw_gemm_kernel(DwArgs)",
    "dw_reduce_kernel(float const*, float*, int, int)",
    "ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevKernelArgs)",
    "void at::native::elementwise_kernel<128, 4>(int)",
    "void at::native::reduce_kernel<128, 4>(ReduceOp)",
]
# as the profiler named them in traced train steps on the H100 (torch
# 2.11.0+cu128), argument lists cut
CUBLAS_KERNELS = [
    "nvjet_tst_128x64_64x8_1x2_h_bz_splitK_NTT",
    "nvjet_tst_256x128_64x4_1x2_h_bz_coopA_TNT",
    "void cutlass::Kernel2<cutlass_80_tensorop_bf16_s16816gemm_bf16_256x128_"
    "64x3_tn_align2>(cutlass_80_tensorop_bf16_s16816gemm_bf16_256x128_64x3_"
    "tn_align2::Params)",
    "void cutlass::Kernel2<cutlass_75_tensorop_s1688gemm_bf16_128x128_nt_"
    "align1>(cutlass_75_tensorop_s1688gemm_bf16_128x128_nt_align1::Params)",
    "void cutlass::Kernel2<cutlass_80_simt_sgemm_256x128_8x4_nt_align1>("
    "cutlass_80_simt_sgemm_256x128_8x4_nt_align1::Params)",
    "sm80_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize64x64x8_stage3_warpsize1x4"
    "x1_ffma_aligna4_alignc4_execute_split_k_kernel__5x_cublas",
    "void cublasLt::splitKreduce_kernel<32, 16, int, __nv_bfloat16, "
    "__nv_bfloat16, float, __nv_bfloat16, false, __nv_bfloat16, "
    "__nv_bfloat16, __nv_bfloat16, true, false, false, false>("
    "cublasLt::cublasSplitKParams<float>)",
]
# the batch-norm fold's products, which gemm_work does not count
GEMV = ("std::enable_if<!(false), void>::type internal::gemvx::kernel<int, "
        "int, float, float, float, float, false, true, false, false, 6, "
        "false>(cublasGemvParamsEx<int>)")


def _cfg(name):
    return harness.load_json(harness.HERE, "configs", name + ".json")


def test_products_of_no_dropout_at_64x300():
    n = 64 * 300
    assert gemm_work.products(_cfg("no_dropout"), 64, 300) == [
        (n, 5 * 23, 512, 2, 2),          # layer 0 unfolded: no dx
        (n, 512, 512, 2, 3), (n, 512, 1536, 2, 3),
        (64, 3072, 512, 4, 3), (64, 512, 512, 4, 3), (64, 512, 7185, 4, 3)]


def test_least_time_by_hand_at_64x300():
    # layer 0 at 64 x 300: 2.26 GFLOP (2.29 us at 989 TFLOP/s) against
    # 24.19 MB (7.22 us at 3.35 TB/s): bound by its bytes, twice
    n = 64 * 300
    l0 = max(2 * n * 115 * 512 / 989e12,
             2 * (n * 115 + 115 * 512 + n * 512) / 3.35e12)
    assert l0 == pytest.approx(7.2222e-6, rel=1e-4)
    cfg = dict(_cfg("no_dropout"), kernel_sizes=[5], dilations=[1],
               channels=[512], embed_dims=[], num_targets=1024)
    # the head alone after pooling: 1024 x 1024 f32 at 64 rows, 3 calls
    head = max(2 * 64 * 1024 * 1024 / 989e12,
               4 * (64 * 1024 + 1024 * 1024 + 64 * 1024) / 3.35e12)
    assert gemm_work.least_time(cfg, [(64, 300)]) == pytest.approx(
        2 * l0 + 3 * head)
    assert gemm_work.least_time(cfg, [(64, 300)] * 3) == pytest.approx(
        3 * (2 * l0 + 3 * head))


def test_etdnn_counts_its_six_dense_layers():
    cfg = _cfg("etdnn")
    prods = gemm_work.products(cfg, 64, 300)
    frame = [p for p in prods if p[0] == 64 * 300]
    assert [(p[1], p[2], p[4]) for p in frame] == [
        (115, 512, 2)] + [(512, 512, 3)] * 5 + [(512, 1500, 3)]
    # with K2-K4's layers, every frame MAC of the step is counted once
    macs = sum(p[1] * p[2] for p in frame) + sum(
        k * cin * cout for k, cin, cout, _ in work.wide_layers(cfg))
    assert macs == work.stack_macs_per_frame(cfg) == 4_496_896


def _tables_without_cublas(directory):
    """The shipped role tables but cublas.json, loaded from a copy."""
    for name in os.listdir(os.path.join(harness.HERE, "kernels")):
        if name.endswith(".json") and name != "cublas.json":
            with open(os.path.join(harness.HERE, "kernels", name), "rb") as f:
                (directory / name).write_bytes(f.read())
    return trace.load_roles(str(directory))


def test_cublas_table_takes_no_port_kernel(tmp_path):
    with open(os.path.join(harness.HERE, "kernels", "cublas.json")) as f:
        table = json.load(f)["roles"]
    assert table and {e["role"] for e in table} == {"gemm"}
    roles = trace.load_roles()
    before = _tables_without_cublas(tmp_path)
    for name in PORT_KERNELS:
        assert trace.role_of(name, roles) == trace.role_of(name, before)
        assert trace.role_of(name, roles) != "gemm"


def test_cublas_table_names_the_step_gemms():
    roles = trace.load_roles()
    for name in CUBLAS_KERNELS:
        assert trace.role_of(name, roles) == "gemm", name
    assert trace.role_of(GEMV, roles) == "other"


def test_reader_reads_gemm_time_over_the_bound():
    cfg = _cfg("no_dropout")
    read = harness.load_reader("train_gemm_roofline")
    assert read({"cfg": cfg, "chips": 1}) is None
    mbs = [(64, 300)] * 4
    least = gemm_work.least_time(cfg, mbs)
    c = {"cfg": cfg, "chips": 1, "trace_minibatches": [mbs],
         "traces": [{"role_s": {"gemm": 4 * least, "conv_fwd": 1.0}}]}
    assert read(c) == pytest.approx(25.0)
