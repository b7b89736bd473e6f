"""The port's jax-free tools (``f2nerf_torch/tools``) against the scripts
they port, on the same inputs: offline eval (scripts/eval.py),
inter_poses (scripts/inter_poses.py) and the LLFF pose pipeline
(scripts/poses/pose_utils.py: a COLMAP text model, the save_poses ->
load_data round trip, minify), as tests/test_poses_tooling.py drives the
scripts."""

import filecmp
import importlib.util
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
from PIL import Image

from f2nerf_torch.tools import eval as teval
from f2nerf_torch.tools import inter_poses as tinter
from f2nerf_torch.tools import pose_utils as tpose

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(REPO, "scripts")
sys.path.insert(0, SCRIPTS)

from poses import pose_utils as spose  # noqa: E402


def load_script(name: str):
    spec = importlib.util.spec_from_file_location(f"script_{name}",
                                                  os.path.join(SCRIPTS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def random_poses(rng, n):
    poses = np.zeros((n, 3, 5))
    for i in range(n):
        q, _ = np.linalg.qr(rng.standard_normal((3, 3)))
        if np.linalg.det(q) < 0:
            q[:, 0] *= -1
        poses[i, :, :3] = q
        poses[i, :, 3] = rng.standard_normal(3) * 2
        poses[i, :, 4] = (480, 640, 500.0)
    return poses


def write_pngs(d, rng, n, h, w, prefix="img"):
    os.makedirs(d, exist_ok=True)
    for i in range(n):
        Image.fromarray((rng.random((h, w, 3)) * 255).astype(np.uint8)).save(
            os.path.join(d, f"{prefix}{i:03d}.png"))


def same_tree(a, b):
    cmp = filecmp.dircmp(a, b)
    assert not (cmp.left_only or cmp.right_only or cmp.diff_files or cmp.funny_files), \
        (cmp.left_only, cmp.right_only, cmp.diff_files)
    for sub in cmp.common_dirs:
        same_tree(os.path.join(a, sub), os.path.join(b, sub))


def test_tools_import_without_jax():
    code = ("import f2nerf_torch.tools.eval, f2nerf_torch.tools.inter_poses, "
            "f2nerf_torch.tools.pose_utils, sys; "
            "assert 'jax' not in sys.modules and 'f2nerf_tpu' not in sys.modules")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True)


def test_eval_matches_script(tmp_path, monkeypatch):
    infos = {}
    for side in ("script", "port"):
        base = tmp_path / side
        rng = np.random.default_rng(0)
        for scene in ("s0", "s1"):
            write_pngs(base / scene / "gt", rng, 3, 24, 32)
            for method in ("m0", "m1"):
                write_pngs(base / scene / method, rng, 3, 24, 32, prefix="pd")
        args = ["--base_data_dir", str(base), "--scenes", "s0,s1", "--methods", "m0,m1"]
        if side == "script":
            monkeypatch.setattr(sys, "argv", ["eval.py"] + args)
            load_script("eval").main()
        else:
            teval.main(args)
        for scene in ("s0", "s1"):
            for method in ("m0", "m1"):
                with open(base / scene / method / "info.json") as f:
                    infos[(side, scene, method)] = json.load(f)
    for scene in ("s0", "s1"):
        for method in ("m0", "m1"):
            a, b = infos[("port", scene, method)], infos[("script", scene, method)]
            assert a.keys() == b.keys() and a["psnr"].keys() == b["psnr"].keys()
            for metric in a:
                np.testing.assert_array_equal(np.array(list(a[metric].values()), float),
                                              np.array(list(b[metric].values()), float))
            assert len(a["psnr"]) == 4 and np.isfinite(a["ssim"]["mean"])
    # a method with a missing image is refused
    os.remove(next((tmp_path / "port" / "s0" / "m0").glob("*.png")))
    with pytest.raises(ValueError, match="2 images for 3"):
        teval.main(["--base_data_dir", str(tmp_path / "port"), "--scenes", "s0",
                    "--methods", "m0"])


def test_inter_poses_matches_script(tmp_path, monkeypatch):
    rng = np.random.default_rng(3)
    key = random_poses(rng, 6)[:, :, :4]
    script = load_script("inter_poses")
    for n_out, sigma in ((30, 1.0), (17, 0.5)):
        np.testing.assert_array_equal(tinter.inter_poses(key, n_out, sigma),
                                      script.inter_poses(key, n_out, sigma))
    for side in ("script", "port"):
        d = tmp_path / side
        d.mkdir()
        cams = np.zeros((6, 27))
        cams[:, :12] = key.reshape(6, 12)
        np.save(d / "cams_meta.npy", cams)
        args = ["--data_dir", str(d), "--key_poses", "0,2,5", "--n_out_poses", "12"]
        if side == "script":
            monkeypatch.setattr(sys, "argv", ["inter_poses.py"] + args)
            script.main()
        else:
            tinter.main(args)
    got = np.load(tmp_path / "port" / "poses_render.npy")
    assert got.shape == (12, 3, 4) and got.dtype == np.float64
    np.testing.assert_array_equal(got, np.load(tmp_path / "script" / "poses_render.npy"))


def write_colmap_text_model(d, rng, n_images=4, n_points=60):
    """A COLMAP sparse/0 text model: one PINHOLE camera, images named out
    of order, each seeing a random subset of the points."""
    os.makedirs(d)
    with open(os.path.join(d, "cameras.txt"), "w") as f:
        f.write("# camera list\n1 PINHOLE 640 480 500.0 500.0 320.0 240.0\n")
    xyz = rng.standard_normal((n_points, 3))
    with open(os.path.join(d, "points3D.txt"), "w") as f:
        f.write("# points\n")
        for p in range(n_points):
            f.write(f"{p + 1} {xyz[p, 0]} {xyz[p, 1]} {xyz[p, 2]} 1 2 3 0.5 1 0\n")
    with open(os.path.join(d, "images.txt"), "w") as f:
        f.write("# images\n")
        for i in range(n_images):
            q = rng.standard_normal(4)
            q /= np.linalg.norm(q)
            t = rng.standard_normal(3)
            name = f"im{(i * 3) % n_images}.png"
            f.write(f"{i + 1} {' '.join(map(str, q))} {' '.join(map(str, t))} 1 {name}\n")
            seen = rng.choice(n_points, 20, replace=False) + 1
            f.write(" ".join(f"{rng.random() * 640} {rng.random() * 480} {p}" for p in seen)
                    + " 10.0 20.0 -1\n")


def test_pose_pipeline_matches_script(tmp_path):
    """load_colmap_data on a text model, save_poses, load_data (at full
    size and at factor 2, which minifies) and minify: the same arrays and
    the same files from both."""
    rng = np.random.default_rng(5)
    src = tmp_path / "src"
    write_colmap_text_model(str(src / "sparse" / "0"), rng)
    write_pngs(src / "images", rng, 4, 48, 64)
    got = {}
    for side, mod in (("script", spose), ("port", tpose)):
        base = tmp_path / side
        shutil.copytree(src, base)
        poses, pts, vis = mod.load_colmap_data(str(base))
        mod.save_poses(str(base), poses, pts, vis)
        full = mod.load_data(str(base), load_imgs=True)
        half = mod.load_data(str(base), factor=2, load_imgs=True)
        mod.minify(str(base), resolutions=[[24, 40]])
        got[side] = (poses, pts, vis) + full + half
    for a, b in zip(got["port"], got["script"]):
        np.testing.assert_array_equal(a, b)
    poses, pts, vis = got["port"][:3]
    assert poses.shape == (4, 3, 5) and pts.shape == (60, 3) and vis.shape == (60, 4)
    assert vis.sum() == 80
    assert got["port"][-1].shape == (4, 24, 32, 3)
    same_tree(str(tmp_path / "port"), str(tmp_path / "script"))
    for d in ("images_2", "images_40x24", "view_cloud"):
        assert len(os.listdir(tmp_path / "port" / d)) == 4, d
