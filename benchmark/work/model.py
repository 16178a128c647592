"""Model FLOPs of a request or a training step, from the widths and the shapes.

Every 2D and 3D conv, transposed conv and dense layer of the network, the
bundle head on every sample its bundles hold (the dense layout pays
``max_num_samples`` for every bundle), the decoder, and for training the
stage NeRF, the SSIM filters and the VGG16 blocks of the loss.  A
multiply-add counts 2; a transposed conv counts its input voxels.  Norms,
activations, gathers, softmaxes, sums and the camera geometry are not
counted.  A training step adds, for each layer, the product for the input's
gradient where the input needs one and for the weight's gradient where the
weight is trained.  ``tests/test_bench_work.py`` holds these counts to
torch's FLOP counter on the plain reference at a small size.

``cfg`` is the configuration's tree as a dict (``fpn``, ``mvs``, ``nerf``).
"""

from __future__ import annotations

from typing import NamedTuple


class Layer(NamedTuple):
    name: str
    macs: int  # multiply-adds of the forward
    dgrad: bool  # the backward computes the input's gradient
    wgrad: bool  # the backward computes the weight's gradient


def _conv(name, out_px, c_in, c_out, k, dgrad=True, wgrad=True, groups=1):
    return Layer(name, out_px * c_out * (c_in // groups) * k, dgrad, wgrad)


def fpn(cfg: dict, n: int, H: int, W: int, train: bool) -> list[Layer]:
    """The feature pyramid over ``n`` images of H x W.  In training, the
    full-resolution head (``inner2``, ``out2``) gets no gradient: no later
    stage reads it at bundle size 2."""
    bc = cfg["fpn"]["base_channels"]
    o0, o1, o2 = cfg["fpn"]["feat_dims"]
    p1, p2, p4 = n * H * W, n * (H // 2) * (W // 2), n * (H // 4) * (W // 4)
    unused = cfg["nerf"]["bundle_size"] >= 2
    return [
        _conv("fpn.conv0.0", p1, 3, bc, 9, dgrad=False),
        _conv("fpn.conv0.1", p1, bc, bc, 9),
        _conv("fpn.conv1.0", p2, bc, 2 * bc, 25),
        _conv("fpn.conv1.1", p2, 2 * bc, 2 * bc, 9),
        _conv("fpn.conv2.0", p4, 2 * bc, 4 * bc, 25),
        _conv("fpn.conv2.1", p4, 4 * bc, 4 * bc, 9),
        _conv("fpn.out0", p4, 4 * bc, o0, 1),
        _conv("fpn.inner1", p2, 2 * bc, 4 * bc, 1),
        _conv("fpn.out1", p2, 4 * bc, o1, 9),
        _conv("fpn.inner2", p1, bc, 4 * bc, 1, dgrad=not unused, wgrad=not unused),
        _conv("fpn.out2", p1, 4 * bc, o2, 9, dgrad=not unused, wgrad=not unused),
    ]


def unet(name: str, c_in: int, voxel: int, bc: int, B: int, D: int, h: int, w: int,
         levels: int) -> list[Layer]:
    """A cost-regularisation U-Net with ``levels`` stride-2 stages (2: the
    coarse stage's, 3: the fine stage's) on a (B, c_in, D, h, w) volume."""
    def px(lv):
        return B * (D >> lv) * (h >> lv) * (w >> lv)

    out = [_conv(f"{name}.conv0", px(0), c_in, bc, 27)]
    c = bc
    for lv in range(1, levels + 1):
        out.append(_conv(f"{name}.down{lv}", px(lv), c, 2 * c, 27))
        out.append(_conv(f"{name}.same{lv}", px(lv), 2 * c, 2 * c, 27))
        c *= 2
    for lv in range(levels, 0, -1):  # transposed: the input's voxels
        out.append(_conv(f"{name}.up{lv}", px(lv), c, c // 2, 27))
        c //= 2
    out.append(_conv(f"{name}.feat_head", px(0), bc, voxel, 27))
    out.append(_conv(f"{name}.prob_head", px(0), bc, 1, 27))
    return out


def mvs(cfg: dict, B: int, H: int, W: int) -> list[Layer]:
    """Both cascade stages' U-Nets: the first stage's 2-level net, then
    3-level nets."""
    m = cfg["mvs"]
    bc = cfg["fpn"]["base_channels"]
    out = []
    for i, (lvl, s, D) in enumerate(zip(m["vol_levels"], m["vol_scales"], m["num_depth"])):
        out += unet(f"mvs{i}", cfg["fpn"]["feat_dims"][lvl], m["voxel_dim"], bc, B, D,
                    int(H * s), int(W * s), 2 if i == 0 else 3)
    return out


def view_head(name: str, n: int, views: int, feat: int, hid: int, voxel: int,
              out_width: int) -> list[Layer]:
    """An aggregation head on ``n`` samples of ``views`` views, feature
    width ``feat`` (the image feature and its rgb): the view trunk, density,
    the per-view weight layers and, where ``out_width``, the feature head."""
    F, g, img = feat, 32, 16
    shared = hid + voxel + img
    out = [
        Layer(f"{name}.view_fc", views * n * 4 * F, True, True),
        Layer(f"{name}.global_fc.view", views * n * F * g, True, True),
        Layer(f"{name}.global_fc.var_mean", 2 * n * F * g, True, True),
        Layer(f"{name}.agg_w_fc", views * n * g, True, True),
        Layer(f"{name}.fc", n * g * img, True, True),
        Layer(f"{name}.lr0", n * (voxel + img) * hid, True, True),
        Layer(f"{name}.sigma", n * hid, True, True),
        Layer(f"{name}.w0.shared", n * shared * hid, True, True),
        Layer(f"{name}.w0.view", views * n * (F + 4) * hid, True, True),
        Layer(f"{name}.w2", views * n * hid, True, True),
    ]
    if out_width:
        out.append(Layer(f"{name}.feat_head", n * hid * out_width, True, True))
    return out


def bundle_head(cfg: dict, B: int, H: int, W: int, views: int) -> list[Layer]:
    """The bundle head on every sample of the (H/b, W/b) bundle grid."""
    nerf = cfg["nerf"]
    b = nerf["bundle_size"]
    n = B * (H // b) * (W // b) * nerf["max_num_samples"]
    lvl = feature_level(cfg)
    return view_head("head", n, views, cfg["fpn"]["feat_dims"][lvl] + 3,
                     nerf["nerf_hidden_dims"], cfg["mvs"]["voxel_dim"], cfg["mvs"]["voxel_dim"])


def stage_nerfs(cfg: dict, B: int, H: int, W: int, views: int) -> list[Layer]:
    """The training-only stage NeRFs: every stage but the last renders its
    stage-resolution image with ``num_samples`` samples a pixel."""
    m = cfg["mvs"]
    out = []
    for i in range(len(m["vol_levels"]) - 1):
        s = m["vol_scales"][i]
        n = B * int(H * s) * int(W * s) * m["num_samples"][i]
        out += view_head(f"stage{i}", n, views, cfg["fpn"]["feat_dims"][m["vol_levels"][i]] + 3,
                         cfg["nerf"]["nerf_hidden_dims"], m["voxel_dim"], 0)
    return out


def decoder(cfg: dict, B: int, H: int, W: int) -> list[Layer]:
    """The RDN decoder on the bundle grid, its pixel-shuffle stages and the
    full-resolution output conv."""
    nerf = cfg["nerf"]
    b = nerf["bundle_size"]
    c_in = cfg["fpn"]["feat_dims"][feature_level(cfg)] + 3 + cfg["mvs"]["voxel_dim"]
    nf, gr = 64, 32
    px = B * (H // b) * (W // b)
    out = [_conv("dec.in_conv", px, c_in, nf, 9)]
    for i in range(nerf["dec_layers"]):
        out += [_conv(f"dec.rdb{i}.conv1", px, nf, gr, 9),
                _conv(f"dec.rdb{i}.conv2", px, nf + gr, gr, 9),
                _conv(f"dec.rdb{i}.conv3", px, nf + 2 * gr, nf, 9),
                Layer(f"dec.rdb{i}.se", 2 * B * nf * (nf // 16), True, True)]
    scale = 1
    while scale < b:
        out.append(_conv(f"dec.up{scale}", B * (H // b * scale) * (W // b * scale), nf, 4 * nf, 9))
        scale *= 2
    out.append(_conv("dec.out_conv", B * H * W, nf, 3, 1))
    return out


def ssim_filters(n: int, H: int, W: int) -> list[Layer]:
    """SSIM's five depthwise 7x7 filters on (n, H, W, 3); the prediction's
    three (its mean, its square, the product) need the input's gradient."""
    px = n * H * W
    return [_conv(f"ssim.{t}", px, 3, 3, 49, dgrad=d, wgrad=False, groups=3)
            for t, d in (("mu_gt", False), ("mu_pred", True), ("sq_gt", False),
                         ("sq_pred", True), ("prod", True))]


def vgg(n: int, H: int, W: int) -> list[Layer]:
    """VGG16's four blocks on the ground truth and on the prediction; its
    weights are frozen, and only the prediction's pass has a backward."""
    widths = [[(3, 64), (64, 64)], [(64, 128), (128, 128)],
              [(128, 256), (256, 256), (256, 256)], [(256, 512), (512, 512), (512, 512)]]
    out = []
    for side, grad in (("gt", False), ("pred", True)):
        h, w = H, W
        for bi, block in enumerate(widths):
            for ci, (c_in, c_out) in enumerate(block):
                out.append(_conv(f"vgg.{side}.{bi}.{ci}", n * h * w, c_in, c_out, 9,
                                 dgrad=grad, wgrad=False))
            h, w = h // 2, w // 2
    return out


def feature_level(cfg: dict) -> int:
    """The first FPN level whose scale reaches the bundle grid."""
    scales = cfg["fpn"]["feat_scales"]
    lvl = 0
    while lvl < len(scales) and scales[lvl] < 1.0 / cfg["nerf"]["bundle_size"]:
        lvl += 1
    return lvl


def forward_layers(cfg: dict, B: int, H: int, W: int, views: int, train: bool = False):
    return (fpn(cfg, B * views, H, W, train) + mvs(cfg, B, H, W)
            + (stage_nerfs(cfg, B, H, W, views) if train else [])
            + bundle_head(cfg, B, H, W, views) + decoder(cfg, B, H, W))


def loss_layers(cfg: dict, B: int, H: int, W: int) -> list[Layer]:
    """The photometric losses' convs: the final image's and each stage
    render's (SSIM, and VGG16 where the recipe's perceptual weight is on)."""
    m = cfg["mvs"]
    out = ssim_filters(B, H, W) + vgg(B, H, W)
    for i in range(len(m["vol_levels"]) - 1):
        h, w = int(H * m["vol_scales"][i]), int(W * m["vol_scales"][i])
        out += ssim_filters(B, h, w) + vgg(B, h, w)
    return out


def forward_flops(cfg: dict, B: int, H: int, W: int, views: int) -> int:
    """FLOPs of one eval forward (a request of batch B)."""
    return 2 * sum(l.macs for l in forward_layers(cfg, B, H, W, views))


def train_step_flops(cfg: dict, B: int, H: int, W: int, views: int) -> int:
    """FLOPs of one training step: the training forward, the losses and the
    backward."""
    layers = forward_layers(cfg, B, H, W, views, train=True) + loss_layers(cfg, B, H, W)
    return 2 * sum(l.macs * (1 + l.dgrad + l.wgrad) for l in layers)
