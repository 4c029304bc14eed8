"""Two processes equal one in the port (ROADMAP P18): the counterpart of
``tests/test_multihost_2proc.py``, driven by ``tests/torch_mh_worker.py``.

Two real OS processes join one gloo group on the CPU
(``parallel/multihost.initialize_distributed``) and run the recipes of
JAX's ``tests/mh_recipe.py`` at tiny width, on a shared workdir, each on
its half of every global batch; the same recipes then run in this process
with no group. The tolerances are JAX's: the two ranks agree with each
other to 1e-12 (they compute the same global losses and hold the same
weights), and rank 0 equals the one-process run within 1e-3 relative on
every epoch's loss and 5e-3 absolute on the best metric and the test
AUROC (the ranks' gradients sum in another order than one process's).

The ``uneven`` recipe is the global-statistics check: one teacher step on
a batch whose halves have uneven label masks (2 valid labels against 28)
and shifted values. Its losses, BatchNorm running statistics and gradient
must equal the one-process step's (1e-5; the gradient to 1e-5 of its
largest magnitude), and the losses and statistics lie far from what
per-rank means would give (the two halves' steps averaged).

The ``teacher_orbax`` recipe (JAX's ``teacher_orbax``) trains on the orbax
state backend, paused after epoch 1 and resumed: rank 0 alone writes the
steps into the shared directory, both ranks restore from it, and the pair
ends in one state and equals one process.

Multi-step dispatch (``steps_per_call`` 3 over 4 batches an epoch, a group
of 3 and a remainder of 1) in the encode-once teacher, SSL and KD: each
rank's run at K = 3 equals the same pair's run at K = 1 bit for bit (the
history, the best metric, the test AUROC, and a digest of the final
weights, AdamW moments and step generator), logs that its K steps ran as a
loop over gloo, and equals one process at K = 3 within the tolerances
above.

All the recipes run in one launch of the pair (a module fixture), with one
retry on a fresh directory for gloo's startup race, as JAX's
``_run_two_proc`` does.
"""
import json
import math
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import torch_mh_worker as W  # noqa: E402

MULTISTEP = ("teacher_cached", "ssl", "kd")
RECIPES = ("teacher", "teacher_images", "teacher_cached", "teacher_preempt",
           "teacher_preempt_resume", "teacher_orbax", "ssl", "kd",
           "uneven") + tuple(
               f"multistep_{kind}" for kind in MULTISTEP)
LOSS_KEY = {"ssl": "train_loss"}


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run_two_proc_once(workdir) -> list:
    workdir.mkdir(parents=True, exist_ok=True)
    port = _free_port()
    env = dict(os.environ)
    env.pop("WORLD_SIZE", None)
    env["PYTHONPATH"] = os.pathsep.join(
        [HERE, os.path.dirname(HERE), env.get("PYTHONPATH", "")])
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "torch_mh_worker.py"), str(pid),
         "2", str(port), str(workdir), ",".join(RECIPES)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for pid in range(2)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=600)
            outs.append(out.decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{out[-4000:]}"
    results = []
    for pid in range(2):
        with open(workdir / f"result_{pid}.json") as f:
            results.append(json.load(f))
    return results


@pytest.fixture(scope="module")
def two_proc(tmp_path_factory):
    base = tmp_path_factory.mktemp("two_proc")
    try:
        return _run_two_proc_once(base / "a1")
    except Exception as e:   # gloo's startup race: one retry
        print(f"[2proc] first attempt failed ({type(e).__name__}: {e}); "
              "retrying once on a fresh workdir")
        return _run_two_proc_once(base / "a2")


@pytest.fixture(scope="module")
def one_proc(tmp_path_factory):
    """The recipes in this process, no group, each run once when asked."""
    base = tmp_path_factory.mktemp("one_proc")
    cache = {}
    n = torch.get_num_threads()
    torch.set_num_threads(1)

    def run(kind):
        if kind not in cache:
            cache[kind] = W.run_recipe(kind, str(base / kind))
        return cache[kind]

    yield run
    torch.set_num_threads(n)


def _assert_equivalent(kind, r0, r1, single):
    key = LOSS_KEY.get(kind, "train_total")
    assert r0["is_main"] and not r1["is_main"]
    assert r0["best_metric"] == pytest.approx(r1["best_metric"], abs=1e-12)
    has_auroc = not math.isnan(r0["test_auroc"])   # SSL has none
    if has_auroc:
        assert r0["test_auroc"] == pytest.approx(r1["test_auroc"],
                                                 abs=1e-12)
        assert single["test_auroc"] == pytest.approx(r0["test_auroc"],
                                                     abs=5e-3)
    assert len(r0["history"]) == len(r1["history"]) \
        == len(single["history"])
    for h0, h1, hs in zip(r0["history"], r1["history"], single["history"]):
        assert h0[key] == pytest.approx(h1[key], abs=1e-12)
        assert hs[key] == pytest.approx(h0[key], rel=1e-3)
    assert single["best_metric"] == pytest.approx(r0["best_metric"],
                                                  abs=5e-3)
    # only rank 0 names (and wrote) a checkpoint
    assert r0["best_path"] and os.path.exists(r0["best_path"])
    assert r1["best_path"] == ""


@pytest.mark.parametrize("kind", ["teacher", "teacher_images",
                                  "teacher_cached", "teacher_orbax", "ssl",
                                  "kd"])
def test_two_processes_match_one(kind, two_proc, one_proc):
    r0, r1 = (two_proc[i][kind] for i in range(2))
    _assert_equivalent(kind, r0, r1, one_proc(kind))
    if kind == "teacher_orbax":
        # paused after epoch 1 and resumed from rank 0's committed steps:
        # both ranks restored the same state and ended in it
        assert r0["start_epoch"] == r1["start_epoch"] == 1
        assert r0["orbax_steps"] == r1["orbax_steps"] \
            == one_proc(kind)["orbax_steps"] == [0, 1]
        assert r0["digest"] == r1["digest"]
        assert r0["first_history"] == r0["history"][:1]
    if kind == "kd":
        assert r0["teacher_best"] == pytest.approx(r1["teacher_best"],
                                                   abs=1e-12)
    if kind == "teacher_images":
        # each rank decoded only its image_id % 2 share into host RAM; one
        # process took the card-tier bank of every image
        assert r0["image_tier"] == r1["image_tier"] == "host_u8_partition"
        assert one_proc(kind)["image_tier"] == "hbm"
        assert r0["n_images"] + r1["n_images"] \
            == one_proc(kind)["n_images"]
    if kind == "teacher_cached":
        assert r0["feature_tier"] == r1["feature_tier"] == "host"
        assert r0["n_images"] + r1["n_images"] \
            == one_proc(kind)["n_images"]


def test_two_processes_run_the_gradient_diagnostics_as_one(two_proc,
                                                           one_proc):
    """``grad_diag_every`` 1 over processes (ROADMAP P18b): each rank runs
    the diagnostics on the same val rows at every epoch, with no
    collective; the ranks' ``grad_diag/*`` agree to 1e-12 and equal one
    process's within the tolerances above (1e-3 relative, 5e-3 absolute),
    and only rank 0's ``Logger`` printed the reports and its lines."""
    single = one_proc("teacher")
    r0, r1 = (two_proc[i]["teacher"] for i in range(2))
    for h0, h1, hs in zip(r0["history"], r1["history"], single["history"]):
        keys = sorted(k for k in hs if k.startswith("grad_diag/"))
        assert keys and keys == sorted(
            k for k in h0 if k.startswith("grad_diag/")) == sorted(
            k for k in h1 if k.startswith("grad_diag/"))
        assert h0["grad_diag/samples"] == W.DIAG_BATCHES * 32
        for k in keys:
            assert h0[k] == pytest.approx(h1[k], abs=1e-12), k
            assert h0[k] == pytest.approx(hs[k], rel=1e-3, abs=5e-3), k
    n_epochs = len(single["history"])
    assert single["printed_diagnostics"] == r0["printed_diagnostics"] \
        == n_epochs
    assert r1["printed_diagnostics"] == r1["printed_lines"] == 0


def test_sigterm_on_one_rank_stops_both(two_proc, one_proc):
    """Rank 1 alone receives SIGTERM during epoch 1; both ranks stop at its
    end with the state saved (``multihost.any_flag``), and a two-process
    restart resumes to the run's end. Were the flag not shared, rank 0
    would enter epoch 2's collectives alone and hang past the worker's
    timeout."""
    p0, p1 = (two_proc[i]["teacher_preempt"] for i in range(2))
    s0, s1 = (two_proc[i]["teacher_preempt_resume"] for i in range(2))
    assert p0["n_epochs_run"] == p1["n_epochs_run"] == 2
    assert p0["state_saved"] and p1["state_saved"]
    assert s0["n_epochs_run"] == s1["n_epochs_run"] == 4
    for hp, hr in zip(p0["history"], s0["history"]):
        assert hp["train_total"] == hr["train_total"]
    # the interrupted-and-resumed pair equals one uninterrupted process
    _assert_equivalent("teacher_preempt", s0, s1,
                       one_proc("teacher_4epochs"))


def test_uneven_masks_take_global_statistics(two_proc, one_proc):
    """Losses and BatchNorm of a two-rank step are the global batch's: the
    ranks' results equal one process's on the whole batch, and differ from
    the mean of the halves' own steps by far more than the tolerance."""
    one = one_proc("uneven")
    r0, r1 = (two_proc[i]["uneven"] for i in range(2))
    assert r0 == {**r1, "process_id": 0, "is_main": True}
    for k, v in one["losses"].items():
        assert r0["losses"][k] == pytest.approx(v, rel=1e-5, abs=1e-7), k
    for k, v in one["bn"].items():
        np.testing.assert_allclose(r0["bn"][k], v, rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    g, want = np.asarray(r0["grads"]), np.asarray(one["grads"])
    np.testing.assert_allclose(g, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())

    # the control: each half's step alone, as ranks with local statistics
    # would take it, averaged
    tcfg, _ = W.tiny_teacher_cfgs()
    _, _, ads = W.cohort()
    batch = W.uneven_batch(ads)
    W.shifted_grid(ads, batch)
    n = len(batch["stay_rows"]) // 2
    halves = [W.uneven_step(tcfg, ads, {k: v[i * n:(i + 1) * n]
                                        for k, v in batch.items()})
              for i in range(2)]
    local_total = np.mean([h["losses"]["total"] for h in halves])
    assert abs(local_total - one["losses"]["total"]) \
        > 100 * 1e-5 * abs(one["losses"]["total"])
    gaps = [np.max(np.abs(np.mean([h["bn"][k] for h in halves], axis=0)
                          - np.asarray(one["bn"][k])))
            for k in one["bn"] if k.endswith("running_var")]
    assert max(gaps) > 100 * 1e-5


@pytest.mark.parametrize("kind", MULTISTEP)
def test_two_processes_run_k_steps_a_call_as_k_single_steps(kind, two_proc):
    """Each rank's K = 3 run equals the pair's K = 1 run bit for bit, the
    ranks hold the same state, and the K steps ran as a loop over gloo
    (logged before the first step)."""
    r0, r1 = (two_proc[i][f"multistep_{kind}"] for i in range(2))
    for r in (r0, r1):
        k1, k3 = r["k1"], r["k3"]
        assert k3["n_train_steps"] == k1["n_train_steps"] \
            == W.MULTISTEP_BATCHES * 2
        for key in ("history", "best_metric", "digest"):
            assert k3[key] == k1[key], key
        if not math.isnan(k1["test_auroc"]):
            assert k3["test_auroc"] == k1["test_auroc"]
        assert k1["multistep_lines"] == []
        assert k3["multistep_lines"] == [
            f"[multistep] K={W.MULTISTEP_K} as a loop over gloo (a "
            "host-side collective cannot be captured)"]
    assert r0["k3"]["digest"] == r1["k3"]["digest"]


@pytest.mark.parametrize("kind", MULTISTEP)
def test_two_processes_at_k_steps_a_call_match_one(kind, two_proc, one_proc):
    """The pair at K = 3 against one process at K = 3, within the
    tolerances of ``test_two_processes_match_one``; one process logs no
    ``[multistep]`` line on the CPU."""
    r0, r1 = ({**two_proc[i][f"multistep_{kind}"]["k3"],
               "is_main": two_proc[i][f"multistep_{kind}"]["is_main"]}
              for i in range(2))
    single = one_proc(f"multistep_{kind}")
    _assert_equivalent(kind, r0, r1, single["k3"])
    assert single["k3"]["multistep_lines"] == []
    assert single["k3"]["digest"] == single["k1"]["digest"]
