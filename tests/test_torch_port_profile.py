"""The port's tools that profile and verify the model, on the CPU.

(a) ``tools/verify_scene.py``: the port's ``run("cpu")`` against the JAX
    drive (``tools/verify_scene.py``, run in-process through ``runpy`` with
    its stdout captured): the argmin depth error and the adaptive sample
    counts equal, the regressed and composited depth errors and the RGB
    error within SCENE_ATOL; both print their five numbers and pass.
(b) ``tools/roofline.py``: the port's and the JAX tool's per-stage MB, rows
    and floors (their printed table) equal at the same explicit ``--bw --rr
    --gbw``, both through ``runpy``; an envelope file gives the same
    floors; without rates the port prints bytes and rows only.
(c) ``tools/profile_forward.py`` at 64x64 with ``--iters 1``: every stage
    name printed, and the stages chained (``run_stages``) give
    ``Network.forward``'s ``ret`` bit for bit, in float32 and bf16.
(d) ``tools/profile_encode.py`` at 64x64: each piece's output equals the
    matching field of ``encode_samples``'s output, bit for bit, and the
    zero-weight share it prints equals a count made here from the LOD.
(e) ``tools/microbench.py --quick`` and ``tools/microbench_loader.py --n 2``:
    every row printed, the JSON keys present.
(f) ``tools/measure_frame.py --device cpu --n 2`` at 64x64: its numbers and
    JSON line; every device tool stops without a GPU unless given
    ``--device cpu``.
"""

import contextlib
import io
import json
import os
import runpy
import sys

import numpy as np
import pytest
import torch

from gdb_nerf_tpu_torch.ops import bundles
from gdb_nerf_tpu_torch.runtime.renderer import to_device
from gdb_nerf_tpu_torch.tools import (measure_common, measure_frame, microbench,
                                      microbench_loader, profile_encode, profile_forward,
                                      roofline, verify_scene)
from tests.test_torch_port_network import XLA_O0

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENE_ATOL = 1e-5  # float32 geometry of two packages; the numbers are means of |errors|
SMALL = ["--size", "64", "64", "--iters", "1", "--device", "cpu"]


def json_line(text: str, key: str) -> dict:
    (line,) = [json.loads(x) for x in text.splitlines() if x.startswith("{") and key in x]
    return line[key]


def run_main(main, argv) -> str:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(argv)
    return out.getvalue()


def run_script(path: str, argv: list) -> tuple[dict, str]:
    """A script run as ``__main__`` through runpy with ``argv``: its globals
    and its stdout."""
    out, saved = io.StringIO(), sys.argv
    sys.argv = [path, *argv]
    try:
        with contextlib.redirect_stdout(out):
            g = runpy.run_path(path, run_name="__main__")
    finally:
        sys.argv = saved
    return g, out.getvalue()


@contextlib.contextmanager
def xla_o0_everywhere():
    """Every XLA compile inside the block with ``XLA_O0``, as ``run_jitted``
    compiles the JAX references: the JAX drive runs op by op, each op its
    own compile (about 400 of them), which ``run_jitted`` cannot reach."""
    from jax._src import compiler

    get = compiler.get_compile_options

    def with_o0(*args, env_options_overrides=None, **kwargs):
        return get(*args, env_options_overrides={**XLA_O0, **(env_options_overrides or {})},
                   **kwargs)

    compiler.get_compile_options = with_o0
    try:
        yield
    finally:
        compiler.get_compile_options = get


def test_verify_scene_matches_the_jax_drive():
    with xla_o0_everywhere():
        g, jax_out = run_script(os.path.join(REPO, "tools", "verify_scene.py"), [])
    want = {"argmin_depth_err": float(g["argmin_err"]), "mvs_depth_err": float(g["err"]),
            "samples_per_bundle": [float(g["smp"].samples_per_bundle.min()),
                                   float(g["smp"].samples_per_bundle.max())],
            "nerf_depth_err": float(g["nerf_depth_err"]), "rgb_err": float(g["rgb_err"])}
    out = run_main(verify_scene.main, ["--device", "cpu"])
    got = json_line(out, "verify_scene")
    assert got["argmin_depth_err"] == want["argmin_depth_err"]
    assert got["samples_per_bundle"] == want["samples_per_bundle"]
    for key in ("mvs_depth_err", "nerf_depth_err", "rgb_err"):
        assert abs(got[key] - want[key]) <= SCENE_ATOL, (key, got[key], want[key])
    # Both print the five numbers in the same words, and both pass.
    for text in (jax_out, out):
        for words in ("argmin-variance depth err", "MVS regressed depth err",
                      "adaptive samples/bundle: min", "composited depth err", "rgb err vs GT",
                      "SCENE RECONSTRUCTION OK"):
            assert words in text, (words, text)
    verify_scene.check(got)
    with pytest.raises(AssertionError, match="rgb_err"):
        verify_scene.check({**got, "rgb_err": 0.03})


def table_lines(text: str) -> list[str]:
    lines = text.splitlines()
    return lines[lines.index(next(x for x in lines if x.startswith("stage"))):
                 lines.index(next(x for x in lines if x.startswith("TOTAL"))) + 1]


@pytest.mark.parametrize("size,views,rates", [
    (("512", "640"), "3", ("3.35e12", "5e9", "2e12")),
    (("256", "320"), "2", ("819e9", "8e9", "819e9")),
])
def test_roofline_matches_the_jax_tool(tmp_path, size, views, rates):
    bw, rr, gbw = rates
    argv = ["--size", *size, "--views", views, "--bw", bw, "--rr", rr, "--gbw", gbw]
    _, jax_out = run_script(os.path.join(REPO, "tools", "roofline.py"), argv)
    _, port_out = run_script(roofline.__file__, argv)
    want = table_lines(jax_out)
    assert table_lines(port_out) == want and len(want) == 16  # header, 13 stages, rule, TOTAL
    result = json_line(port_out, "roofline")
    assert [r["stage"] for r in result["stages"]] == list(roofline.PROFILE_STAGE)
    assert set(result["floor_ms_by_profile_stage"]) <= set(profile_forward.stage_names())
    # microbench's envelope line gives the same floors as --rr/--gbw.
    env = tmp_path / "envelope.txt"
    env.write_text("device: x\n" + json.dumps({"microbench": {"rr": float(rr),
                                                              "gbw": float(gbw)}}) + "\n")
    out = run_main(roofline.main, argv[:7] + ["--envelope", str(env)])
    assert table_lines(out) == want
    # Without rates: bytes and rows only, the JAX tool's columns.
    out = run_main(roofline.main, argv[:7])
    assert [x.rsplit(maxsplit=1)[0] for x in want[1:]] == table_lines(out)[1:]
    assert "floor_ms" not in json_line(out, "roofline")["stages"][0]


@pytest.fixture(scope="module")
def cfg64():
    """The tools' dtu_eval at 64x64."""
    return profile_forward.profile_cfg((64, 64), 3, 3, "float32")


def test_profile_forward_prints_every_stage_and_chains_the_forward(cfg64):
    out = run_main(profile_forward.main, SMALL + ["--dtype", "float32"])
    result = json_line(out, "profile_forward")
    names = profile_forward.stage_names()
    assert [r["stage"] for r in result["stages"]] == names
    for name in names:
        assert any(line.startswith(name) for line in out.splitlines()), name
    assert result["head_launches"] == 0  # CPU tensors: the plain head
    assert result["sum_ms"] == pytest.approx(sum(r["ms"] for r in result["stages"]))
    for dt in (torch.float32, torch.bfloat16):
        torch.manual_seed(0)
        cfg64.compute_dtype = str(dt).split(".")[1]
        renderer = measure_common.renderer_for(cfg64, "cpu", None)
        batch = to_device(measure_common.first_batches(cfg64, 1)[0], "cpu")
        seen = []

        def step(name, fn):
            seen.append(name)
            return fn()

        with torch.inference_mode():
            chained = profile_forward.run_stages(renderer.network, batch, step)
        ret, _ = renderer.render(batch)
        assert seen == names and sorted(chained) == sorted(ret)
        for key in ret:
            assert torch.equal(chained[key], ret[key]), (dt, key)
    cfg64.compute_dtype = "float32"


def test_profile_encode_pieces_equal_encode_samples(cfg64):
    out = run_main(profile_encode.main, SMALL + ["--dtype", "float32"])
    result = json_line(out, "profile_encode")
    names = ["encode full", "vox fetch", "proj math", "member rgb (xV)", "mip fetch (xV)",
             "ray diff"]
    assert [r["piece"] for r in result["pieces"]] == names
    for name in names:
        assert any(line.startswith(name) for line in out.splitlines()), name
    renderer = measure_common.renderer_for(cfg64, "cpu", None)
    inp = profile_encode.encode_inputs(renderer.network,
                                       to_device(measure_common.first_batches(cfg64, 1)[0], "cpu"))
    calls, proj = profile_encode.pieces(inp)
    with torch.inference_mode():
        enc = calls["encode full"]()
        for name, field in (("member rgb (xV)", enc.rgbs), ("mip fetch (xV)", enc.mip_feat),
                            ("vox fetch", enc.vox_feat), ("ray diff", enc.ray_diff)):
            assert torch.equal(calls[name](), field), name
        assert torch.equal(calls["proj math"]().lod, proj.lod)
    # The printed share: taps with zero tent weight, counted here from the LOD.
    lod = np.clip(proj.lod.numpy().astype(np.float64), 0.0, 3.0)
    zero = sum(int((np.maximum(1.0 - np.abs(lod - lvl), 0.0) == 0.0).sum()) for lvl in range(4))
    share = zero / (lod.size * 4)
    assert result["zero_weight_share"] == pytest.approx(share, abs=1e-12)
    assert f"zero-weight share {share:.4f}" in out
    mip = result["pieces"][4]
    B, V, H, W, S = proj.lod.shape
    assert mip["texel_rows"] == 4 * 4 * V * B * H * W * S == 4 * 4 * 3 * 32 * 32 * 3
    assert result["n_samples"] == B * H * W * S
    assert bundles.mip_texture_fetch is profile_encode.bundles.mip_texture_fetch


def test_microbench_and_loader_print_every_row():
    out = run_main(microbench.main, ["--quick", "--device", "cpu"])
    env = json_line(out, "microbench")
    widths = [str(c) for c in microbench.QUICK["widths"]]
    assert set(env) >= {"bytes_per_s", "rows_per_s", "tflops", "rr", "gbw", "gather",
                        "member_rgb", "conv", "copy", "card", "device"}
    assert set(env["rows_per_s"]) == {*microbench.ROW_CALLS, "grid_sample"}
    for by_width in env["rows_per_s"].values():
        assert list(by_width) == widths and all(v > 0 for v in by_width.values())
    assert len(env["tflops"]) == 4 and env["rr"] > 0 and env["gbw"] > 0
    for c in widths:
        assert f"gather C={int(c):4d}:" in out
    assert out.count("conv ") == 4 and "copy " in out and out.count("member-rgb") == 2
    out = run_main(microbench_loader.main, ["--n", "2", "--frame-ms", "33"])
    result = json_line(out, "microbench_loader")
    assert set(result) == {"rows", "per_frame_decode_ms", "frame_ms", "cv2", "native_decoder",
                           "n"}
    names = [r["name"] for r in result["rows"]]
    if result["cv2"]:
        assert {"cv2.imread 512x640 png", "cv2.imread 1024x1280 pfm"} <= set(names)
    if result["native_decoder"] == "available":
        assert {"native decode 512x640 png", "native pooled decode (4 threads)",
                "native read_pfm 1024x1280"} <= set(names)
    for name in names:
        assert name in out
    assert result["frame_ms"] == 33.0 and "against a 33.00 ms frame" in out


def test_measure_frame_times_frames_on_cpu(monkeypatch):
    """``measure_frame --device cpu --n 2 --set synthetic_hw [64,64]``: the
    dtu_eval forward in bf16 (the tool's default) on the synthetic loader's
    first request, its ms a frame the best of its rounds, the host's
    enqueue beside a request's latency, the frame's H x W, V and S, the
    head's launches (0: the plain head on the CPU) in its warm-up forward,
    the number of forwards it ran, and its JSON line; with ``--device cuda`` and no GPU it stops."""
    out = run_main(measure_frame.main, ["--device", "cpu", "--n", "2", "--set", "synthetic_hw",
                                        "[64,64]"])
    result = json_line(out, "measure_frame")
    assert set(result) == {"config", "dtype", "hw", "views", "samples", "n", "rounds",
                           "ms_per_frame", "fps", "rounds_ms", "latency_ms", "enqueue_ms",
                           "peak_gib", "frames", "head_launches_per_frame",
                           "device", "card"}
    assert (result["config"], result["dtype"], result["hw"], result["views"], result["samples"],
            result["n"], result["card"]) == ("dtu_eval", "bfloat16", [64, 64], 3, 3, 2, "cpu")
    assert result["ms_per_frame"] == min(result["rounds_ms"]) > 0
    assert len(result["rounds_ms"]) == measure_frame.ROUNDS
    assert result["fps"] == pytest.approx(1e3 / result["ms_per_frame"])
    assert result["latency_ms"] > 0 and result["enqueue_ms"] > 0 and result["peak_gib"] is None
    # one warm-up, each round's n + 1 (timed_ms's own warm-up on the CPU), n requests
    assert result["frames"] == 1 + measure_frame.ROUNDS * 3 + 2
    assert result["head_launches_per_frame"] == 0 and "ms/frame" in out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        measure_frame.main(["--device", "cuda", "--n", "2"])


@pytest.mark.parametrize("tool", [profile_forward, profile_encode, microbench, verify_scene,
                                  measure_frame])
def test_device_tools_default_to_the_card(monkeypatch, tool):
    """Without a GPU, the tools that use a device stop unless given --device cpu."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        tool.main([])
    assert "--device cpu" in str(exc.value.code)
