"""mqslam_tpu_torch.eval and its three command lines against the JAX
package's, on the CPU, on in-repo trajectory pairs: the ICL dump's front-end
trajectory against its bundle-adjusted one (``artifacts/icl_r5b``), and the
synthetic cube's ground truth against a noisy copy.  ``associate``, ``ate``
and ``rpe`` are float64 NumPy in both packages: their CLIs' printed lines
and output files are byte-equal.  ``alignment`` runs its quaternions in
float32 in both (the port in torch tensors): values to 1e-6.  The new
``core.quat`` helpers are held to the JAX package's at 1e-6."""

import builtins
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from mqslam_tpu.ba import synthetic as jsyn
from mqslam_tpu.cli import align_traj as jalign, evaluate_ate as jate_cli
from mqslam_tpu.cli import evaluate_rpe as jrpe_cli
from mqslam_tpu.core import quat as jquat
from mqslam_tpu.eval import alignment as jal, associate as jas, rpe as jrpe
from mqslam_tpu.io import pcd as jpcd, tum as jtum
from mqslam_tpu_torch.cli import align_traj as talign
from mqslam_tpu_torch.cli import evaluate_ate as tate_cli
from mqslam_tpu_torch.cli import evaluate_rpe as trpe_cli
from mqslam_tpu_torch.core import quat as tquat
from mqslam_tpu_torch.eval import alignment as tal, associate as tas
from mqslam_tpu_torch.eval import ate as tate, rpe as trpe
from mqslam_tpu_torch.io import tum as ttum
from mqslam_tpu_torch.io.nputil import matrix_to_quat_np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ICL = os.path.join(ROOT, "artifacts", "icl_r5b")


@pytest.fixture
def rng():
    return np.random.RandomState(7)


def quats(rng, n):
    return Rotation.random(n, random_state=rng).as_quat().astype(np.float32)


def test_quat_helpers(rng):
    q1, q2 = quats(rng, 32), quats(rng, 32) * 1.3     # one non-unit set
    p = rng.randn(32, 3).astype(np.float32)
    t = lambda a: torch.tensor(a)
    for fn in ("mult", "conj", "inv", "apply_to_point"):
        args = {"mult": (q1, q2), "conj": (q2,), "inv": (q2,),
                "apply_to_point": (q1, p)}[fn]
        out = getattr(tquat, fn)(*map(t, args))
        ref = np.asarray(getattr(jquat, fn)(*map(jnp.asarray, args)))
        assert out.dtype == torch.float32
        np.testing.assert_allclose(out.numpy(), ref, atol=1e-6, err_msg=fn)


def test_associate(tmp_path, rng):
    t1 = np.sort(rng.uniform(0, 10, 60))
    t2 = np.sort(np.concatenate([t1[::2] + rng.uniform(-0.03, 0.03, 30),
                                 rng.uniform(0, 10, 10)]))
    assert tas.associate_arrays(t1, t2, 0.01, 0.02) == \
        jas.associate_arrays(t1, t2, 0.01, 0.02)
    f = tmp_path / "list.txt"
    f.write_text("# a comment\n1.0,2 3\n2.5\t4 5\n\n3.0 6 7\n")
    a, b = tas.read_file_list(str(f)), jas.read_file_list(str(f))
    assert a == b
    assert tas.associate(a, b) == jas.associate(a, b)


def noisy_cube(tmp_path, rng):
    """The cube's first-camera ground truth and a noisy, shifted copy of it,
    as TUM files."""
    Ws = jsyn.ground_truth_trajectories(1, 20)[0]
    ts = 1.0 + np.arange(20) / 10.0
    R = np.stack([W[:3, :3] for W in Ws])
    c = np.stack([W[:3, 3] for W in Ws])
    gt = tmp_path / "gt.txt"
    est = tmp_path / "est.txt"
    jtum.save_trajectory(str(gt), jtum.CamTrajectory(
        ts, c, matrix_to_quat_np(R)))
    Rn = Rotation.from_rotvec(rng.normal(0, 0.02, (20, 3))).as_matrix() @ R
    jtum.save_trajectory(str(est), jtum.CamTrajectory(
        ts + rng.uniform(-0.004, 0.004, 20), c + rng.normal(0, 0.3, (20, 3))
        + [1.0, -2.0, 0.5], matrix_to_quat_np(Rn)))
    return str(gt), str(est)


def pairs(tmp_path, rng):
    return {"icl": (os.path.join(ICL, "traj_out.cam0-mqslam-BA.txt"),
                    os.path.join(ICL, "traj_out.cam0-mqslam.txt")),
            "cube": noisy_cube(tmp_path, rng)}


def run_both(jmain, tmain, argv, tmp_path, capsys, outputs=()):
    """Both CLIs on ``argv`` (output paths named ``{out}`` are made per
    package): (their stdout, their output files' bytes)."""
    res = []
    for tag, main in (("jax", jmain), ("port", tmain)):
        files = {o: str(tmp_path / f"{tag}-{o}") for o in outputs}
        args = [a.format(**files) for a in argv]
        assert main(args) == 0
        res.append((capsys.readouterr().out,
                    [open(files[o], "rb").read() for o in outputs]))
    return res


@pytest.mark.parametrize("pair", ["icl", "cube"])
@pytest.mark.parametrize("verbose", [False, True])
def test_evaluate_ate_cli(tmp_path, capsys, rng, pair, verbose):
    gt, est = pairs(tmp_path, rng)[pair]
    argv = [gt, est, "--save", "{save}", "--save_associations", "{assoc}"] \
        + (["--verbose"] if verbose else [])
    (oj, fj), (ot, ft) = run_both(jate_cli.main, tate_cli.main, argv,
                                  tmp_path, capsys, ("save", "assoc"))
    assert ot == oj and ft == fj
    assert len(ft[0]) > 100
    # the scale and offset options
    argv = [gt, est, "--scale", "1.5", "--offset", "0.01"]
    (oj, _), (ot, _) = run_both(jate_cli.main, tate_cli.main, argv,
                                tmp_path, capsys)
    assert ot == oj


@pytest.mark.parametrize("pair", ["icl", "cube"])
@pytest.mark.parametrize("mode", [
    ["--fixed_delta"], ["--fixed_delta", "--delta", "3", "--delta_unit",
                        "f"], ["--max_pairs", "500"]])
def test_evaluate_rpe_cli(tmp_path, capsys, rng, pair, mode):
    gt, est = pairs(tmp_path, rng)[pair]
    argv = [gt, est, "--verbose", "--save", "{save}"] + mode
    (oj, fj), (ot, ft) = run_both(jrpe_cli.main, trpe_cli.main, argv,
                                  tmp_path, capsys, ("save",))
    assert ot == oj and ft == fj


@pytest.mark.parametrize("unit", ["s", "f", "m", "rad", "deg"])
def test_rpe_units_and_biased_search(unit):
    """Every delta unit, and the TUM tool's biased binary search: the
    pairs (their stamps) are those of the JAX package's copy."""
    est = ttum.load_trajectory(os.path.join(ICL, "traj_out.cam0-mqslam.txt"))
    gt = ttum.load_trajectory(os.path.join(ICL,
                                           "traj_out.cam0-mqslam-BA.txt"))
    delta = {"s": 0.5, "f": 4, "m": 0.1, "rad": 0.05, "deg": 3.0}[unit]
    a = trpe.evaluate_rpe(est, gt, delta=delta, delta_unit=unit)
    b = jrpe.evaluate_rpe(est, gt, delta=delta, delta_unit=unit)
    np.testing.assert_array_equal(a.pair_stamps, b.pair_stamps)
    np.testing.assert_array_equal(a.trans_errors, b.trans_errors)
    arr = np.array([0.0, 1.0, 2.0, 3.0, 4.0, 5.0, 6.0])
    for v in (2.4, 2.6, 5.9, -1.0, 9.0):
        assert trpe._find_closest(arr, v) == jrpe._find_closest(arr, v)


def test_ate_result(rng):
    est = ttum.load_trajectory(os.path.join(ICL, "traj_out.cam0-mqslam.txt"))
    gt = ttum.load_trajectory(os.path.join(ICL,
                                           "traj_out.cam0-mqslam-BA.txt"))
    r = tate.evaluate_ate(est, gt)
    assert r.n_pairs == len(est.timestamps) and 0 < r.rmse < 0.05
    pts = rng.randn(40, 3)
    R = Rotation.random(random_state=rng).as_matrix()
    R2, t2, err = tate.horn_align(pts, pts @ R.T + [1.0, 2.0, 3.0])
    np.testing.assert_allclose(R2, R, atol=1e-9)
    assert err.max() < 1e-9


def traj_np(t):
    return (np.asarray(t.timestamps), np.asarray(t.locations),
            np.asarray(t.quaternions))


@pytest.mark.parametrize("infer_scale", [True, False])
def test_alignment(rng, infer_scale):
    gt = ttum.load_trajectory(os.path.join(ICL,
                                           "traj_out.cam0-mqslam-BA.txt"))
    est = ttum.load_trajectory(os.path.join(ICL, "traj_out.cam0-mqslam.txt"))
    kw = dict(at_frame=3, infer_scale=infer_scale, offset_frames=40)
    a = tal.transform_between_trajectories(est, gt, device="cpu", **kw)
    b = jal.transform_between_trajectories(est, gt, **kw)
    assert a[0].dtype == np.asarray(b[0]).dtype == np.float32
    np.testing.assert_allclose(a[0], b[0], atol=1e-6)
    assert a[1] == pytest.approx(b[1], rel=1e-6)
    np.testing.assert_allclose(a[2], b[2], atol=1e-6)
    pts = rng.randn(50, 3)
    np.testing.assert_allclose(tal.transform_points(pts, b, device="cpu"),
                               jal.transform_points(pts, b), atol=1e-6)
    ta, tb = tal.transform_trajectory(est, b, device="cpu"), \
        jal.transform_trajectory(est, b)
    for x, y in zip(traj_np(ta), traj_np(tb)):
        np.testing.assert_allclose(x, y, atol=1e-6)
    empty = ttum.CamTrajectory(np.zeros(0), np.zeros((0, 3)),
                               np.zeros((0, 4)))
    out = tal.transform_between_trajectories(empty, gt, device="cpu")
    np.testing.assert_array_equal(out[0], [0, 0, 0, 1])


def test_align_traj_cli(tmp_path, capsys):
    files = {}
    for tag in ("jax", "port"):
        d = tmp_path / tag
        d.mkdir()
        for f in ("traj_out.cam0-mqslam.txt", "map_out-mqslam.pcd",
                  "traj_out.cam0-mqslam-BA.txt"):
            (d / f).write_bytes(open(os.path.join(ICL, f), "rb").read())
        files[tag] = d
    argv = lambda d: [str(d / "traj_out.cam0-mqslam-BA.txt"),
                      str(d / "traj_out.cam0-mqslam.txt"), "--maps",
                      str(d / "map_out-mqslam.pcd"), "--at-frame", "5"]
    assert jalign.main(argv(files["jax"])) == 0
    assert talign.main(argv(files["port"]) + ["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.count("wrote") == 4
    for stem in ("traj_out.cam0-mqslam-trfm.txt", "map_out-mqslam-trfm.pcd"):
        a, b = (str(files[t] / stem) for t in ("jax", "port"))
        if stem.endswith(".txt"):
            for x, y in zip(traj_np(jtum.load_trajectory(a)),
                            traj_np(jtum.load_trajectory(b))):
                np.testing.assert_allclose(y, x, atol=1e-6)
        else:
            pa, ca, _ = jpcd.load_pcd(a, use_alpha=True)
            pb, cb, _ = jpcd.load_pcd(b, use_alpha=True)
            np.testing.assert_allclose(pb, pa, atol=1e-5)
            np.testing.assert_array_equal(cb, ca)


def test_plot(tmp_path, capsys, monkeypatch):
    gt = os.path.join(ICL, "traj_out.cam0-mqslam-BA.txt")
    est = os.path.join(ICL, "traj_out.cam0-mqslam.txt")
    pytest.importorskip("matplotlib")
    assert tate_cli.main([gt, est, "--plot", str(tmp_path / "a.png")]) == 0
    assert trpe_cli.main([gt, est, "--fixed_delta", "--plot",
                          str(tmp_path / "r.png")]) == 0
    assert (tmp_path / "a.png").stat().st_size > 1000
    assert (tmp_path / "r.png").stat().st_size > 1000
    with pytest.raises(SystemExit):
        trpe_cli.main([gt, est, "--plot", str(tmp_path / "x.png")])


def test_plot_without_matplotlib(tmp_path, capsys, monkeypatch):
    """Without matplotlib, --plot fails with a message before any work;
    every other option runs."""
    real = builtins.__import__

    def no_mpl(name, *a, **kw):
        if name == "matplotlib" or name.startswith("matplotlib."):
            raise ImportError("no matplotlib")
        return real(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_mpl)
    monkeypatch.delitem(sys.modules, "matplotlib", raising=False)
    gt = os.path.join(ICL, "traj_out.cam0-mqslam-BA.txt")
    est = os.path.join(ICL, "traj_out.cam0-mqslam.txt")
    for main, extra in ((tate_cli.main, []),
                        (trpe_cli.main, ["--fixed_delta"])):
        with pytest.raises(SystemExit) as e:
            main([gt, est, "--plot", str(tmp_path / "p.png")] + extra)
        assert e.value.code == 2
        assert "matplotlib" in capsys.readouterr().err
        assert not (tmp_path / "p.png").exists()
        assert main([gt, est] + extra) == 0
