"""The ICP update step of ``pyfocusr_tpu_torch`` (``umeyama_kernel.icp_step``:
the matched rows' moments, the close, the moved source, the masked motion
and the stop flag), its plain version against the numpy emulation of its
kernel, and the kernel's wrapper.

* ``chip_smoke.icp_step_emulated`` mirrors ``icp_step_kernel``
  (csrc/umeyama3.cu): one-pass f64 sums, ``close_emulated`` (Jacobi with the
  kernel's stop rule), the moved rows in f64 rounded once, the masked motion
  in f64, the flag.  ``icp_step_plain`` (two-pass f64 moments, the f64
  ``torch.linalg.svd`` close) must agree with it on the step cases
  ``chip_smoke.py`` runs on the card (``icp_step_case_inputs``): each close
  case, the first ICP iteration of the 2562-vertex synthetic bones (seeds 1
  onto 2) rigid and similarity, and a case with sentinel (1e30) target rows
  and source rows dropped by the mask at the sentinel.  s, R, t within the
  close's limits (R 1e-6, s rtol 1e-6, t 1e-6 of the coordinates' scale),
  moved within 1e-6 of the larger of that scale and its magnitude, delta
  within rtol 1e-6, count and flag equal (``chip_smoke.step_within``): the
  two take the same f64 quantities in different orders and through
  different SVDs, so they meet at f32 rounding.
* On a set flag the plain step (and the emulation) leave every state buffer
  and the count bit for bit.
* The wrapper's checks raise on CPU tensors and on wrong shapes, dtypes or
  contiguity; its constants equal the kernel's; ``plan`` takes one CTA up
  to ``ONE_CTA_MAX_ROWS`` rows.
* On a card (``gpu`` marker): the kernel against the plain step on the same
  cases and tolerances, the set flag bit for bit.
"""

import re

import numpy as np
import pytest
import torch

import chip_smoke
import pyfocusr_tpu_torch as tp
from pyfocusr_tpu_torch.ops import icp as TI
from pyfocusr_tpu_torch.ops import umeyama_kernel as UK

torch.set_num_threads(1)

CASE_NAMES = [c[0] for c in chip_smoke.CLOSE_CASES] + [
    "kd_first_iteration_scale_False", "kd_first_iteration_scale_True", "flag_set",
    "sentinel_rows"]


def _bones_call(device="cpu"):
    """The 2562-vertex synthetic bones as an ICP call: every source vertex
    onto the target."""
    src = torch.tensor(chip_smoke.synthetic_bone(tp, 1, levels=4).points, device=device)
    tgt = torch.tensor(chip_smoke.synthetic_bone(tp, 2, levels=4).points, device=device)
    return (src, tgt), {}


@pytest.fixture(scope="module")
def step_cases():
    return dict(chip_smoke.icp_step_case_inputs(torch, TI, _bones_call(), device="cpu"))


def test_case_names_are_the_chip_cases(step_cases):
    assert list(step_cases) == CASE_NAMES


@pytest.mark.parametrize("name", CASE_NAMES)
def test_plain_step_matches_kernel_emulation(step_cases, name):
    a = step_cases[name]
    p = chip_smoke.clone_step_args(a)
    UK.icp_step_plain(**p)
    (es, eR, et, em, ed), ectrl, rotations = chip_smoke.step_emulation(a)
    if name == "flag_set":
        for got, given in zip(p["state"] + (p["ctrl"],), a["state"] + (a["ctrl"],)):
            assert torch.equal(got, given)
        assert ectrl == (3, 1) and rotations == 0
        for got, given in zip((es, eR, et, em, ed), a["state"]):
            np.testing.assert_array_equal(got, given.numpy())
        return
    target = a["target"]
    scale = float(target[target.abs().max(dim=1).values < 1e29].abs().max())
    errs = chip_smoke.step_errors(p["state"], (es, eR, et, em, ed), p["ctrl"].tolist(), ectrl,
                                  scale)
    assert chip_smoke.step_within(errs), errs
    assert p["ctrl"].tolist()[0] == 1 and 1 <= rotations <= 3 * chip_smoke.close_sweeps()
    assert np.isfinite(float(p["state"][4]))
    if name == "sentinel_rows":  # the dropped rows moved, but added nothing
        dropped = a["mask"] == 0
        assert dropped.any() and (p["state"][3][dropped].abs() > 1e29).all()
        kept = chip_smoke.clone_step_args(a)
        keep = ~dropped
        only = dict(kept, src=a["src"][keep].contiguous(), mask=a["mask"][keep].contiguous(),
                    wn=a["wn"][keep].contiguous(), idx=a["idx"][keep].contiguous(),
                    state=kept["state"][:3] + (kept["state"][3][keep].contiguous(),
                                               kept["state"][4]))
        UK.icp_step_plain(**only)
        np.testing.assert_allclose(float(only["state"][4]), float(p["state"][4]), rtol=1e-6)


def test_plain_step_on_set_flag_writes_nothing(step_cases):
    a = chip_smoke.clone_step_args(step_cases["kd_first_iteration_scale_True"])
    a["ctrl"][:] = torch.tensor([7, 1], dtype=torch.int32)
    before = [x.clone() for x in a["state"] + (a["ctrl"],)]
    UK.icp_step(**a)
    for got, want in zip(a["state"] + (a["ctrl"],), before):
        assert torch.equal(got, want)


def test_plain_step_sets_flag_at_the_cap_and_on_nan(step_cases):
    a = chip_smoke.clone_step_args(step_cases["rotation"])
    a["max_iterations"] = 1
    UK.icp_step_plain(**a)
    assert a["ctrl"].tolist() == [1, 1]  # the cap, the motion still above
    b = chip_smoke.clone_step_args(step_cases["rotation"])
    b["state"][3][0, 0] = float("nan")  # a kept row: the motion is NaN
    e = chip_smoke.step_emulation(chip_smoke.clone_step_args(b))
    UK.icp_step_plain(**b)
    assert np.isnan(float(b["state"][4])) and b["ctrl"].tolist() == [1, 1]
    assert np.isnan(e[0][4]) and e[1] == (1, 1)


def test_step_dispatch_takes_plain_on_cpu(step_cases):
    a, b = (chip_smoke.clone_step_args(step_cases["similarity"]) for _ in range(2))
    before = UK.LAUNCHES
    UK.icp_step(**a)
    UK.icp_step_plain(**b)
    assert UK.LAUNCHES == before
    for x, y in zip(a["state"] + (a["ctrl"],), b["state"] + (b["ctrl"],)):
        assert torch.equal(x, y)


def test_step_cuda_wrapper_checks(step_cases):
    a = chip_smoke.clone_step_args(step_cases["rotation"])
    with pytest.raises(ValueError, match="CUDA"):
        UK.icp_step_cuda(**a)
    cpu = torch.device("cpu")
    args = {k: a[k] for k in ("target", "idx", "src", "mask", "wn", "mu_s", "var_s", "state",
                              "ctrl", "threshold")}
    UK._check_step_args(**args, dev=cpu)
    UK._check_step_args(**dict(args, idx=args["idx"].reshape(-1)), dev=cpu)
    n = a["src"].shape[0]
    s, R, t, moved, delta = a["state"]
    bad = [
        ("src", a["src"][:, :2]),
        ("target", a["target"].T.contiguous()),
        ("idx", args["idx"].long()),
        ("idx", args["idx"][: n - 1]),
        ("mask", a["mask"].double()),
        ("wn", a["wn"][: n - 1]),
        ("mu_s", a["mu_s"][:2]),
        ("var_s", a["var_s"].reshape(1)),
        ("threshold", a["threshold"].double()),
        ("ctrl", a["ctrl"].float()),
        ("ctrl", torch.zeros(3, dtype=torch.int32)),
        ("state", (s.reshape(1), R, t, moved, delta)),
        ("state", (s, R.T, t, moved, delta)),  # not contiguous
        ("state", (s, R, t, moved[:, :2], delta)),
        ("state", (s, R, t.double(), moved, delta)),
    ]
    for key, value in bad:
        with pytest.raises(ValueError, match="icp_step_cuda needs"):
            UK._check_step_args(**dict(args, **{key: value}), dev=cpu)
    with pytest.raises(ValueError, match="on cuda"):
        UK._check_step_args(**args, dev=torch.device("cuda"))


def test_step_constants_and_plan():
    with open(chip_smoke.os.path.join(chip_smoke.ROOT, "pyfocusr_tpu_torch", "csrc",
                                      "umeyama3.cu")) as f:
        src = f.read()
    assert int(re.search(r"constexpr int kThreads = (\d+);", src).group(1)) == UK.THREADS
    assert int(re.search(r"constexpr int kMaxCtas = (\d+);", src).group(1)) == UK.MAX_CTAS
    rows = int(re.search(r"constexpr int kRows = (\d+);", src).group(1))
    assert UK.ONE_CTA_MAX_ROWS <= rows * UK.THREADS  # a CTA's rows fit its registers
    negl = float(re.search(r"constexpr double kNegligible2 = ([0-9.e-]+);", src).group(1))
    assert negl == chip_smoke.CLOSE_NEGLIGIBLE2
    for n in (1, UK.ONE_CTA_MAX_ROWS):
        assert UK.plan(n)["ctas"] == 1
    last = 1
    for n in (UK.ONE_CTA_MAX_ROWS + 1, 3 * UK.ONE_CTA_MAX_ROWS, 10 ** 6, 10 ** 9):
        ctas = UK.plan(n)["ctas"]
        assert ctas & (ctas - 1) == 0 and last <= ctas <= UK.MAX_CTAS
        assert ctas == UK.MAX_CTAS or n <= ctas * UK.ONE_CTA_MAX_ROWS
        last = ctas


@pytest.mark.gpu
def test_step_kernel_matches_plain_on_card():
    """Runs on a CUDA card only: ``icp_step_cuda`` against
    ``icp_step_plain`` on the same card, every case, one launch each."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for name, a in chip_smoke.icp_step_case_inputs(torch, TI, _bones_call("cuda"),
                                                   device="cuda"):
        k, p = chip_smoke.clone_step_args(a), chip_smoke.clone_step_args(a)
        before = UK.LAUNCHES
        UK.icp_step(**k)
        assert UK.LAUNCHES == before + 1
        UK.icp_step_plain(**p)
        torch.cuda.synchronize()
        if name == "flag_set":
            for got, given in zip(k["state"] + (k["ctrl"],), a["state"] + (a["ctrl"],)):
                assert torch.equal(got, given)
            continue
        target = a["target"]
        scale = float(target[target.abs().max(dim=1).values < 1e29].abs().max())
        errs = chip_smoke.step_errors(k["state"], p["state"], k["ctrl"].tolist(),
                                      p["ctrl"].tolist(), scale)
        assert chip_smoke.step_within(errs), (name, errs)
