"""Work counts by hand arithmetic, and role tables that leave unmatched
kernels in ``other``."""

import json

import pytest

from xvbench import harness, trace, work


def _cfg(name):
    if name == "etdnn":     # the E-TDNN's frame layers on no_dropout's input
        return dict(_cfg("no_dropout"), preset="etdnn",
                    kernel_sizes=[5, 1, 3, 1, 3, 1, 3, 1, 1, 1],
                    dilations=[1, 1, 2, 1, 3, 1, 4, 1, 1, 1],
                    channels=[512] * 9 + [1500])
    return harness.load_json(harness.HERE, "configs", name + ".json")


def test_frame_stack_macs_per_frame():
    # no_dropout: 5*23*512 + 5*512*512 + 7*512*512 + 512*512 + 512*1536
    assert work.stack_macs_per_frame(_cfg("no_dropout")) == (
        58_880 + 1_310_720 + 1_835_008 + 262_144 + 786_432) == 4_253_184
    # etdnn: 5*23*512 + five 512x512 k=1 + three 3*512*512 + 512*1500
    assert work.stack_macs_per_frame(_cfg("etdnn")) == (
        58_880 + 5 * 262_144 + 3 * 786_432 + 768_000) == 4_496_896


def test_wide_layers_are_k2_k4s():
    assert [l[0] for l in work.wide_layers(_cfg("no_dropout"))] == [5, 7]
    assert [(l[0], l[3]) for l in work.wide_layers(_cfg("etdnn"))] == [
        (3, 2), (3, 3), (3, 4)]


def test_conv_least_time_is_the_operation_bound_at_64x304():
    cfg = _cfg("no_dropout")
    t = work.conv_least_time(cfg, [(64, 304)])
    flops = 2 * 64 * 304 * 512 * 512 * (5 + 7)
    assert t == pytest.approx(3 * flops / work.PEAK_FLOPS)
    assert work.conv_least_time(cfg, [(64, 304)] * 2) == pytest.approx(2 * t)


def test_train_flops_per_audio_second():
    cfg = _cfg("no_dropout")
    per_s = work.train_flops(cfg, [(1, 100)])
    # 3 x 8.506 MFLOP per frame less layer 0's input gradient, plus the
    # head per row
    stack = 2 * 100 * (3 * 4_253_184 - 58_880)
    head = 2 * 3 * (3072 * 512 + 512 * 512 + 512 * 7185)
    assert per_s == stack + head
    assert 2.5e9 < per_s < 2.6e9


def test_stack_least_time_adds_per_layer_bounds():
    cfg = _cfg("no_dropout")
    one = work.stack_least_time(cfg, 32 * 1024)
    assert one > 2 * 32 * 1024 * 4_253_184 / work.PEAK_FLOPS
    assert work.stack_least_time(cfg, 0) > 0     # the weights' bytes


def test_unmatched_kernels_count_as_other(tmp_path):
    (tmp_path / "a.json").write_text(json.dumps(
        {"roles": [{"pattern": "fwd_sm90_kernel<0>", "role": "conv_fwd"}]}))
    roles = trace.load_roles(str(tmp_path))
    assert trace.role_of("void fwd_sm90_kernel<0>(CUtensorMap_st)",
                         roles) == "conv_fwd"
    assert trace.role_of("void at::native::elementwise_kernel<128, 4>",
                         roles) == "other"


def test_a_role_with_no_kernel_reads_as_missing():
    assert work.roofline(1e-3, 0.0) is None
    assert work.roofline(0.0, 1e-3) is None
    assert work.roofline(1e-3, 4e-3) == pytest.approx(25.0)


def test_shipped_role_tables_name_the_port_kernels():
    roles = trace.load_roles()
    for name, role in [
            ("void fwd_sm90_kernel<0>(CUtensorMap_st, CUtensorMap_st)",
             "conv_fwd"),
            ("void fwd_sm90_kernel<1>(CUtensorMap_st)", "frame_stack_fwd"),
            ("void fwd_sm90_kernel<2>(CUtensorMap_st)", "frame_stack_fwd"),
            ("void tdnn_l0_sm90_kernel<1>(CUtensorMap_st)",
             "frame_stack_fwd"),
            ("void dw_sm90_kernel<256>(CUtensorMap_st)", "conv_dw"),
            ("dx_sm90_kernel(CUtensorMap_st, CUtensorMap_st)", "conv_dx"),
            ("ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevKernelArgs)",
             "nccl")]:
        assert trace.role_of(name, roles) == role


def test_metric_readers_leave_out_what_they_cannot_read():
    for m in harness.benchmark()["per_layer"]:
        assert harness.load_reader(m["name"])({"cfg": _cfg("no_dropout"),
                                               "chips": 1}) is None
