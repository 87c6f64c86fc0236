"""Headless CLI surface (app/cli.py — the Main.cpp analogue): flag handling,
exit codes, PNG output, frame sequences. The CLI had only manual coverage
before round 4 despite being a primary user/driver surface."""

import os

import numpy as np
import pytest

from gltf_renderer.app.cli import main
from gltf_renderer.utils.png import load_png
from tests.scenes import write_box_gltf


@pytest.fixture(scope="module")
def box(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("cli") / "box.gltf")
    write_box_gltf(path)
    return path


def _png(path):
    img = load_png(path)
    assert img.dtype == np.uint8 and img.ndim == 3 and img.shape[2] == 3
    return img


def test_cli_pt_render(box, tmp_path):
    out = str(tmp_path / "out.png")
    rc = main(["--gltf", box, "--width", "64", "--height", "48",
               "--spp", "2", "--output", out])
    assert rc == 0
    assert _png(out).shape == (48, 64, 3)


def test_cli_raster_render(box, tmp_path):
    out = str(tmp_path / "out.png")
    rc = main(["--gltf", box, "--width", "64", "--height", "48",
               "--backend", "rasterizer", "--output", out])
    assert rc == 0
    assert _png(out).shape == (48, 64, 3)


def test_cli_debug_output_channel(box, tmp_path):
    out = str(tmp_path / "dbg.png")
    rc = main(["--gltf", box, "--width", "48", "--height", "32",
               "--spp", "1", "--debug-output", "11", "--output", out])
    assert rc == 0
    img = _png(out)
    assert img.max() > 0  # shading normals visible


def test_cli_frame_sequence_naming(box, tmp_path):
    out = str(tmp_path / "seq.png")
    rc = main(["--gltf", box, "--width", "32", "--height", "24",
               "--spp", "1", "--frames", "2", "--output", out])
    assert rc == 0
    assert os.path.exists(str(tmp_path / "seq_0000.png"))
    assert os.path.exists(str(tmp_path / "seq_0001.png"))


def test_cli_shard_auto(box, tmp_path):
    out = str(tmp_path / "sh.png")
    rc = main(["--gltf", box, "--width", "48", "--height", "32",
               "--spp", "1", "--shard", "auto", "--output", out])
    assert rc == 0
    assert _png(out).shape == (32, 48, 3)


def test_cli_missing_scene_exit_codes(tmp_path):
    assert main(["--output", str(tmp_path / "x.png")]) == 2  # no --gltf
    assert main(["--gltf", str(tmp_path / "nope.gltf"),
                 "--output", str(tmp_path / "x.png")]) == 1  # load failure


def test_cli_bad_environment_map(box, tmp_path):
    bad = str(tmp_path / "bad.hdr")
    with open(bad, "wb") as f:
        f.write(b"not an hdr")
    rc = main(["--gltf", box, "--environment-map", bad,
               "--output", str(tmp_path / "x.png")])
    assert rc == 1
