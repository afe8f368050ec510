"""The port stands alone: it imports torch, never jax, nothing of the JAX
package and not OpenCV (the card's machine has none); its entry points run
on a CUDA device unless the caller asks for the CPU; a kernel wrapper takes
its plain version only for CPU tensors.
"""

import os
import pkgutil
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import mqslam_tpu_torch
from mqslam_tpu_torch import convert, csrc
from mqslam_tpu_torch.frontend import tracker as trk
from mqslam_tpu_torch.ops import lk_fused, lk_tile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "mqslam_tpu_torch")


def port_modules():
    names = ["mqslam_tpu_torch"]
    for m in pkgutil.walk_packages([PKG], prefix="mqslam_tpu_torch."):
        names.append(m.name)
    return names


def test_slice_modules_present():
    mods = set(port_modules())
    for m in ("core.smallmat", "core.quat", "core.so3", "core.se3",
              "core.camera", "ops.linalg", "ops.lk", "ops.lk_tile",
              "ops.features", "ops.homography", "ops.triangulation",
              "ops.pnp", "frontend.synthetic", "frontend.tracker", "convert",
              "csrc", "ops.lk_fused", "frontend.runner", "cli",
              "cli.slam_run", "io", "io.tum", "io.pcd", "io.ba_info",
              "io.intrinsics", "io.images", "io.nputil", "ops.extract",
              "ops.lk_iterate", "bench", "ba", "ba.factors", "ba.problem",
              "ba.solver", "ba.polish64", "ba.validate", "ba.synthetic",
              "ba.packed", "ba.banded", "ba.incremental", "cli.ba_run", "eval", "eval.associate", "eval.ate",
              "eval.rpe", "eval.alignment", "cli.evaluate_ate",
              "cli.evaluate_rpe", "cli.align_traj", "multiagent",
              "multiagent.merge", "multiagent.fleet_dump", "parallel",
              "parallel.sharded_ba", "parallel.multihost", "parallel.fleet",
              "parallel.dryrun", "cli.collab_demo"):
        assert "mqslam_tpu_torch." + m in mods, m
    for f in ("lk_level.cu", "lk_strip.cu", "lk_track.cuh", "extract.cu",
              "lk_iterate.cu"):
        assert os.path.exists(os.path.join(PKG, "csrc", f))
    assert csrc.sources() == ["extract", "lk_iterate", "lk_level",
                              "lk_strip"]


def test_import_pulls_in_neither_jax_nor_the_jax_package():
    """Nor OpenCV."""
    code = (
        "import importlib, sys\n"
        "before = set(sys.modules)\n"     # whatever a site hook preloaded
        f"for m in {port_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(k for k in set(sys.modules) - before if k == 'jax' or "
        "k.startswith('jax.') or k == 'jaxlib' or k == 'mqslam_tpu' or "
        "k.startswith('mqslam_tpu.') or k == 'cv2' or "
        "k.startswith('cv2.'))\n"
        "print('BAD', bad)\n")
    # a fresh interpreter without inherited module search paths
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout


def test_sources_name_neither_jax_nor_the_jax_package():
    pat = re.compile(
        r"^\s*(import|from)\s+(jax|jaxlib|mqslam_tpu)(\.|\s|$)", re.M)
    # OpenCV: never at a module's top level; inside a function only in the
    # bench, whose host baseline is OpenCV's ladder where it imports
    cv_top = re.compile(r"^(import|from)\s+cv2(\.|\s|$)", re.M)
    cv_any = re.compile(r"^\s*(import|from)\s+cv2(\.|\s|$)", re.M)
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, fs in os.walk(PKG):
        files += [os.path.join(d, f) for f in fs if f.endswith(".py")]
    assert len(files) > 15
    for path in files:
        with open(path) as f:
            src = f.read()
        assert not pat.search(src), path
        assert "import_module(\"jax" not in src and \
            "__import__(\"jax" not in src, path
        assert not cv_top.search(src), path
        if os.path.basename(path) != "bench.py":
            assert not cv_any.search(src), path


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_need_a_cuda_device_by_default(no_cuda):
    cal9 = [300.0, 300.0, 0, 160, 120, 0, 0, 0, 0]
    with pytest.raises(RuntimeError, match="CUDA"):
        mqslam_tpu_torch.resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        convert.cal_from_numpy(cal9)
    cal = convert.cal_from_numpy(cal9, device="cpu")
    cfg = trk.TrackerConfig(max_tracks=32)
    for make in (trk.make_multi_agent_runner, trk.make_scan_runner,
                 trk.make_step):
        with pytest.raises(RuntimeError, match="CUDA"):
            make(cal, cfg)
        make(cal, cfg, device="cpu")           # asked for: fine
    with pytest.raises(RuntimeError, match="CUDA"):
        trk.bootstrap(np.zeros((8, 2), np.float32),
                      np.zeros((8, 3), np.float32), cal,
                      np.zeros((48, 64), np.float32), cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        convert.state_from_numpy({})
    from mqslam_tpu_torch.ba import banded, packed, synthetic
    with pytest.raises(RuntimeError, match="CUDA"):
        synthetic.generate_corridor_problem(8, 2)
    ids = (np.arange(8) % 4, np.arange(8) % 3, np.ones(8, bool), 4, 3)
    for build in (packed.build_packed_layout, banded.build_banded_layout):
        with pytest.raises(RuntimeError, match="CUDA"):
            build(*ids)             # NumPy ids: the tables go to the card
    assert mqslam_tpu_torch.resolve_device("cpu") == torch.device("cpu")


def test_multi_agent_entry_points_need_a_cuda_device_by_default(no_cuda):
    """The slice's entry points (the fleet runner, the sharded layout
    builders on NumPy ids, the collaborative demo) take the CUDA device
    unless asked for the CPU, and never fall back."""
    from mqslam_tpu_torch.ba import banded, packed
    from mqslam_tpu_torch.cli import collab_demo
    from mqslam_tpu_torch.parallel import fleet
    cal = convert.cal_from_numpy([300.0, 300.0, 0, 160, 120, 0, 0, 0, 0],
                                 device="cpu")
    cfg = trk.TrackerConfig(max_tracks=32)
    with pytest.raises(RuntimeError, match="CUDA"):
        fleet.make_fleet_runner(cal, cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        fleet.make_fleet_runner(cal, cfg, shard=(0, 2))
    fleet.make_fleet_runner(cal, cfg, shard=(0, 2), device="cpu")
    ids = (np.arange(16) % 8, np.arange(16) % 3, np.ones(16, bool), 8, 3, 2)
    for build in (packed.build_sharded_packed_layout,
                  banded.build_sharded_banded_layout):
        with pytest.raises(RuntimeError, match="CUDA"):
            build(*ids)
    with pytest.raises(RuntimeError, match="CUDA"):
        collab_demo.run(n_frames=2, verbose=False)


def _level_args(device="cpu"):
    rng = np.random.RandomState(0)
    img = torch.tensor((rng.rand(80, 90) * 255).astype(np.float32),
                       device=device)
    c = torch.tensor([[20, 30], [25, 22]], dtype=torch.int32, device=device)
    aJ = torch.tensor([[1.2, 1.7], [1.0, 1.5]], device=device)
    a0 = torch.tensor([[7.0, 7.5], [6.0, 8.0]], device=device)
    valid = torch.tensor([True, True], device=device)
    return (img, img.roll(1, 1).contiguous(), c, c, aJ, a0, valid, 1, 21,
            30, 0.01, 13.0)


def test_wrapper_takes_plain_version_for_cpu_tensors_only():
    before = lk_tile.launches
    a, eig, err = lk_tile.lk_level(*_level_args())
    ref = lk_tile.lk_level_plain(*_level_args())
    assert lk_tile.launches == before
    for x, y in zip((a, eig, err), ref):
        np.testing.assert_array_equal(x.numpy(), y.numpy())
    # any other device is the kernel's or an error, never the plain version
    meta = [x.to("meta") if torch.is_tensor(x) else x for x in _level_args()]
    with pytest.raises(RuntimeError, match="unsupported device"):
        lk_tile.lk_level(*meta)
    assert lk_tile.launches == before


def test_strip_wrapper_takes_plain_version_for_cpu_tensors_only():
    args = _level_args()
    args = args[:7] + args[8:]              # the strip level has no tile count
    before = lk_fused.launches
    out = lk_fused.lk_level(*args)
    ref = lk_fused.lk_level_plain(*args)
    tiled = lk_tile.lk_level_plain(*_level_args())   # one tile: same function
    assert lk_fused.launches == before
    for x, y, z in zip(out, ref, tiled):
        np.testing.assert_array_equal(x.numpy(), y.numpy())
        np.testing.assert_array_equal(x.numpy(), z.numpy())
    meta = [x.to("meta") if torch.is_tensor(x) else x for x in args]
    with pytest.raises(RuntimeError, match="unsupported device"):
        lk_fused.lk_level(*meta)
    assert lk_fused.launches == before


def test_build_digest_covers_shared_headers(monkeypatch, tmp_path):
    """A kernel's library is rebuilt when a header it may include changes."""
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "k.cu").write_text('#include "h.cuh"\n')
    (src / "h.cuh").write_text("// one\n")
    monkeypatch.setattr(csrc, "SRC_DIR", str(src))
    first = csrc._target("k")[1]
    assert csrc._target("k")[1] == first
    (src / "h.cuh").write_text("// two\n")
    assert csrc._target("k")[1] != first
    assert csrc.sources() == ["k"]


def test_kernel_build_needs_the_compiler(monkeypatch, tmp_path):
    """No nvcc here: building raises (it does not fall back), and says
    what is missing.  With a card the wrapper would reach this same
    ``load``."""
    monkeypatch.setattr(csrc, "BUILD_DIR", str(tmp_path / "_build"))
    monkeypatch.setattr(csrc.shutil, "which", lambda _: None)
    monkeypatch.setattr(csrc.os.path, "exists", lambda p: False)
    for name in csrc.sources():
        with pytest.raises(RuntimeError, match="nvcc"):
            csrc.load(name)


def test_chip_smoke_fails_without_a_cuda_device():
    """No result line and a non-zero exit code on a machine without a
    card."""
    out = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the script would run in full")
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
