"""The frozen counts against hand counts, and the kernel attribution."""
import pytest

from portbench import counts, spec

FBMS = spec.config("fbms_pc")
HOWTO = spec.config("howto_convex")


def test_bench_prior_macs_by_hand():
    # RealNVP: 12 couplings, s and t each 2 -> 32 -> 2: 4 x 64 MACs
    flow = 12 * (2 * 32 * 2 + 2 * 32 * 2)
    # ICNN 130 x 2: input 2 -> 130, two blocks 130 -> 130 plus the 2 -> 130
    # skip, out 130 -> 1 plus the 2 -> 1 skip
    icnn = 2 * 130 + 2 * (130 * 130 + 2 * 130) + 130 + 2
    assert counts.prior_macs(FBMS) == flow + icnn == 37784
    # chip_smoke.bound_ms counts each coupling's second layers as one dense
    # 64 -> 4 block (39,320); the model's matrices are block diagonal
    assert 39320 - counts.prior_macs(FBMS) == 12 * 128


def test_convex_next_net_macs_by_hand():
    assert counts.prior_macs(HOWTO) == 2 * 130 + 130 * 130 + 2 * 130 \
        + 130 + 2 == 17552
    assert counts.fit_flops_per_point_step(HOWTO) == 105312


def test_param_counts():
    assert counts.prior_params(HOWTO) == (2 * 130 + 130) \
        + (130 * 130 + 130 + 2 * 130) + (130 + 1 + 2)
    flow = 12 * (2 * (2 * 32 + 32 + 32 * 2 + 2) + 4)
    assert counts.prior_params(FBMS) == 4 + flow + (2 * 130 + 130) \
        + 2 * (130 * 130 + 130 + 2 * 130) + 133


def test_unet_macs_by_hand():
    h, w = 480, 640
    px = [h * w // 4 ** i for i in range(5)]  # 480x640 down to 30x40

    def dc(ci, co, n):
        return 9 * n * (ci * co + co * co)

    hand = (dc(4, 64, px[0]) + dc(64, 128, px[1]) + dc(128, 256, px[2])
            + dc(256, 512, px[3]) + dc(512, 512, px[4])
            + dc(1024, 256, px[3]) + dc(512, 128, px[2])
            + dc(256, 64, px[1]) + dc(128, 64, px[0]) + 64 * px[0])
    assert counts.unet_macs(FBMS, h, w) == hand
    assert abs(hand - 1.4512e11) < 1e8


def test_joint_flops():
    f = counts.joint_flops_per_step(FBMS, 480, 640, 2)
    assert f == 6 * 2 * (counts.unet_macs(FBMS, 480, 640) + 37784 * 307200)


def test_bounds():
    t, by = counts.flagship_bound_s(FBMS, 307200, 1)
    assert by == "operations"
    assert t == pytest.approx(6 * 37784 * 307200 / 67e12)
    t4, _ = counts.icnn_bound_s(HOWTO, 307200, 8, False)
    t5, _ = counts.icnn_bound_s(HOWTO, 307200, 8, True)
    assert t5 == pytest.approx(3 * t4)
    assert t4 == pytest.approx(2 * 17552 * 307200 * 8 / 67e12)
    # a tiny launch is bound by its bytes
    assert counts.icnn_bound_s(HOWTO, 4, 1, False)[1] == "bytes"


def test_per_kernel_gives_each_reduce_to_its_kernel():
    ops = [("void (anonymous namespace)::flagship_fwd_bwd<64, false>", 0.0,
            5.0, 7),
           ("void (anonymous namespace)::reduce_tiles", 5.0, 5.25, 7),
           ("void (anonymous namespace)::icnn_fwd<4, true>", 6.0, 7.0, 7),
           ("void (anonymous namespace)::icnn_bwd<4, true>", 7.0, 9.0, 7),
           ("void (anonymous namespace)::reduce_tiles", 9.0, 9.5, 7),
           ("ncclDevKernel_AllReduce_Sum_f32", 6.0, 6.5, 9),
           ("void at::native::elementwise", 9.5, 9.6, 7)]
    k = counts.per_kernel(ops)
    assert k["flagship"] == {"launches": 1, "seconds": 5.25}
    assert k["icnn_fwd"] == {"launches": 1, "seconds": 1.0}
    assert k["icnn_bwd"] == {"launches": 1, "seconds": 2.5}
    assert k["nccl"]["seconds"] == 0.5
