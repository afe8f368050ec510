"""The port's two-agent collaborative demo (``cli.collab_demo``, BASELINE
config #4) end to end on the CPU: two front-end runs -> per-agent BA dumps
-> merge with rendezvous cross-factors -> joint BA over a one-rank gloo
group (``parallel.multihost.global_group``).

Held to ``tests/test_collab_e2e.py``'s bounds (whole-run ATE is chaotic
across packages, so the properties are held here and parity per function
in ``test_torch_multiagent.py`` / ``test_torch_sharded_ba.py``): the mean
joint ATE below the mean front-end's, no agent's joint ATE above 1.25x its
front-end's, the mean joint ATE at most 1.10x the mean independent BA's,
every stage under 5 cm."""

import numpy as np
import pytest
import torch
import torch.distributed as dist


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """torch on one thread: test files run side by side in parallel
    workers, and one thread each keeps them from starving each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def stages():
    from mqslam_tpu_torch.cli import collab_demo
    return collab_demo.run_stages(n_frames=32, verbose=False, device="cpu")


def test_joint_beats_frontend(stages):
    table = stages[0]
    mean_fe = np.mean([v[0] for v in table.values()])
    mean_joint = np.mean([v[2] for v in table.values()])
    assert mean_joint < mean_fe, table
    for a, (fe, ind, joint) in table.items():
        assert joint < fe * 1.25, (a, table)


def test_joint_at_least_as_good_as_independent_on_average(stages):
    table = stages[0]
    mean_ind = np.mean([v[1] for v in table.values()])
    mean_joint = np.mean([v[2] for v in table.values()])
    assert mean_joint <= mean_ind * 1.10, table


def test_all_stages_reasonable(stages):
    table, details = stages
    assert sorted(table) == [0, 1]
    for a, vals in table.items():
        for v in vals:
            assert v < 0.05, table
    # the joint graph: two cameras, cross-factors at the rendezvous
    # frames, solved over one rank whose group is gone afterwards
    merged = details["merged"]
    assert merged.nr_cameras == 2 and details["world"] == 1
    assert sum(1 for s in merged.odometry_assocs for (fc, _, tc, _) in s
               if fc != tc) == 8
    hist = details["history"]
    assert hist[-1] < hist[0] and np.isfinite(hist).all()
    assert not dist.is_initialized()
