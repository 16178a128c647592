"""The frozen work counts: model FLOPs against torch's FLOP counter on the
plain reference at a small size on the CPU, and the copies of the program's
kernel work count and peaks against the program's own."""

import json

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import common, spec, train_data
from benchmark.reference import scenes, train_step
from benchmark.reference import weights as seeded
from benchmark.work import bundle_head, model, peaks

HW = (128, 160)  # the smallest frame at which every U-Net level and VGG block is whole
# Torch's counter also counts the camera geometry's small products, which
# the model count leaves out: a few hundredths of a percent here.
REL = 1e-3


def config(name):
    return json.loads((spec.HERE / "configs" / f"{name}.json").read_text())["cfg"]


def network(cfg, seed=3):
    net = common.reference_network(cfg, "cpu")
    net.load_state_dict(seeded.network_state(net, seed, "cpu"))
    return net


@pytest.mark.parametrize("views", [2, 3])
def test_forward_flops_match_the_counter(views, few_threads):
    cfg = config("dtu_eval")
    net = network(cfg).eval()
    exts, K = scenes.extrinsics(3, 1), scenes.intrinsics(HW)
    req = scenes.request_inputs(scenes.render(exts, K, HW, "cpu")[0], exts[0], K, views)
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        net(req)
    want = model.forward_flops(cfg, 1, *HW, views)
    assert abs(want / fc.get_total_flops() - 1) < REL


def test_train_step_flops_match_the_counter(few_threads):
    cfg = config("dtu_pretrain")
    net = network(cfg).train()
    exts, K = scenes.extrinsics(4, 2), scenes.intrinsics(HW)
    imgs = scenes.render(exts, K, HW, "cpu").numpy()
    batch = train_data.collate([scenes.train_item(imgs[i], exts[i], K, 3, cfg["mvs"]["vol_scales"])
                                for i in range(2)])
    vgg = seeded.vgg(4, "cpu")
    with FlopCounterMode(display=False) as fc:
        loss = train_step.loss(net, train_step.device_batch(batch, "cpu"),
                               cfg["mvs"]["loss_weight"], vgg)
        torch.autograd.grad(loss, list(net.parameters()), allow_unused=True)
    want = model.train_step_flops(cfg, 2, *HW, 3)
    assert abs(want / fc.get_total_flops() - 1) < REL


def test_protocol_sizes():
    """The counts at the cells' sizes, for the record: a dtu_eval frame, a
    1088x1920 frame and a dtu_pretrain step at V = 3."""
    f = model.forward_flops(config("dtu_eval"), 1, 512, 640, 3)
    assert 1.2e11 < f < 1.4e11
    assert 6.0 < model.forward_flops(config("dtu_eval"), 1, 1088, 1920, 3) / f < 6.7
    assert 3.5e12 < model.train_step_flops(config("dtu_pretrain"), 4, 512, 640, 3) < 4.5e12


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n, views", [(245_760, 3), (960_000, 4), (1_000, 2)])
def test_bundle_head_work_is_the_programs(n, views, dtype):
    from gdb_nerf_tpu_torch.kernels import bundle_head as program

    assert bundle_head.work(n, views, str(dtype).split(".")[1]) == program.work(n, views, dtype)
    assert (program.FEAT_RGB_DIM, program.PAYLOAD_DIM, program.VOXEL_DIM, program.HIDDEN_DIM) == (
        bundle_head.FEAT_RGB_DIM, bundle_head.PAYLOAD_DIM, bundle_head.VOXEL_DIM,
        bundle_head.HIDDEN_DIM)


def test_peaks_are_the_published_ones():
    from gdb_nerf_tpu_torch.kernels import measure

    assert peaks.BYTES_PER_S == measure.H100_BYTES_PER_S
    assert peaks.FLOPS["float32"] == measure.H100_PEAK_FLOPS[torch.float32]
    assert peaks.FLOPS["bfloat16"] == measure.H100_PEAK_FLOPS[torch.bfloat16]
    assert np.isclose(peaks.bound_s(3.35e12, 0, "float32"), 1.0)
    assert np.isclose(peaks.bound_s(0, 989e12, "bfloat16"), 1.0)
