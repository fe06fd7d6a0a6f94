"""Consolidated results of the PyTorch/CUDA port: the counterpart of
experiments/tools/gen_results.py, measuring the port (torch, numpy and
scipy only; no JAX) on the machine it runs on.

It writes docs/results_torch/*.jsonl and renders docs/RESULTS_TORCH.md from
them. The JAX tool's docs/results/ and docs/RESULTS.md are never read or
written. Every record carries the card it was measured on, as
`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` gives it
("cpu" on a machine without one), and the render prints it beside every
number.

Usage (from the repository root):
  python -m diffusionnet_tpu_torch.experiments.tools.gen_results \\
      --sections eigen,synthetic,render    # on the card (--device cuda)
  python -m diffusionnet_tpu_torch.experiments.tools.gen_results \\
      --sections soak,render          # the card, about 10 minutes

Sections:
  bench      the port's own benchmark results (bench_torch*.json at the
             repository root; none yet: rendered as "no port benchmark yet")
  eigen      the port's device eigensolver (B5 on a card, the ELL gather on
             the CPU) against host ARPACK on a 20k-vertex grid, k 128
  parity     the port's checkpoint-conversion and parity tests
             (tests/test_torch_convert_checkpoint.py); records skips as
             "skipped: reference checkpoints absent"
  synthetic  the port's three synthetic examples end to end, their final
             numbers parsed from their output
  soak       the synthetic E1 example at the full schedule (200 epochs,
             megakernel + bf16) on the card
  render     regenerate docs/RESULTS_TORCH.md from whatever jsonl files exist

eigen, synthetic and soak run on --device (default cuda, which raises
without a card). A section whose run fails writes no record, and the tool
then exits non-zero after the other sections.
"""

from __future__ import annotations

import argparse
import datetime
import glob
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "..",
                                    ".."))
OUT_DIR = os.path.join(REPO, "docs", "results_torch")
RENDERED = os.path.join(REPO, "docs", "RESULTS_TORCH.md")
NO_CARD = "cpu"


class SectionFailed(RuntimeError):
    """A section's run failed; the section wrote no record."""


def card_line() -> str:
    """The card's name and power limit as nvidia-smi reports them, or
    "cpu" where there is no card."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return NO_CARD
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if out.returncode == 0 and lines else NO_CARD


def _write_jsonl(name: str, records: list[dict], out_dir: str = OUT_DIR):
    os.makedirs(out_dir, exist_ok=True)
    stamp = datetime.datetime.now(datetime.timezone.utc).isoformat(
        timespec="seconds")
    with open(os.path.join(out_dir, name + ".jsonl"), "w") as f:
        for r in records:
            f.write(json.dumps({"generated_utc": stamp, **r}) + "\n")
    print(f"wrote {os.path.relpath(out_dir, REPO)}/{name}.jsonl "
          f"({len(records)} records)")


def _read_jsonl(name: str, out_dir: str = OUT_DIR) -> list[dict]:
    path = os.path.join(out_dir, name + ".jsonl")
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(ln) for ln in f if ln.strip()]


# ---------------------------------------------------------------------------
# sections

def section_bench(out_dir: str = OUT_DIR, root: str = REPO) -> None:
    """The port's own benchmark files only (bench_torch*.json); a TPU
    BENCH_*.json of the JAX package is never read."""
    records = []
    for path in sorted(glob.glob(os.path.join(root, "bench_torch*.json"))):
        with open(path) as f:
            data = json.load(f)
        for entry in data if isinstance(data, list) else [data]:
            records.append({"artifact": os.path.basename(path), **entry})
    _write_jsonl("bench", records, out_dir)


def flat_grid(n: int, jitter: float = 0.0, seed: int = 0):
    """n x n unit-square grid in the z=0 plane, interior vertices jittered
    by up to jitter / n (the JAX tool's eigen mesh). Returns (verts,
    faces)."""
    xs = np.linspace(0.0, 1.0, n)
    X, Y = np.meshgrid(xs, xs, indexing="ij")
    verts = np.stack([X.ravel(), Y.ravel(), np.zeros(n * n)], axis=1)
    if jitter:
        rs = np.random.RandomState(seed)
        interior = ((verts[:, 0] > 0) & (verts[:, 0] < 1)
                    & (verts[:, 1] > 0) & (verts[:, 1] < 1))
        verts[:, :2] += (interior[:, None] * (rs.rand(n * n, 2) - 0.5)
                         * jitter / n)
    i, j = np.meshgrid(np.arange(n - 1), np.arange(n - 1), indexing="ij")
    v00 = (i * n + j).ravel()
    v01, v10, v11 = v00 + 1, v00 + n, v00 + n + 1
    faces = np.concatenate([np.stack([v00, v10, v11], 1),
                            np.stack([v00, v11, v01], 1)])
    order = np.stack([np.arange(len(v00)), len(v00) + np.arange(len(v00))],
                     1).ravel()
    return verts, faces[order].astype(np.int64)


def _spectral_diffusion(ev, evec, mass, x, ts):
    """Heat-diffusion outputs D_t x = Phi e^{-lambda t} (Phi^T M x), one
    (V, C) array per t."""
    return [evec @ (np.exp(-ev * t)[:, None] * (evec.T @ (mass[:, None] * x)))
            for t in ts]


def parity_errs(ev_h, evec_h, ev_d, evec_d, mass, x, ts):
    """Gauge-invariant parity of a device basis against the host one, as
    the network reads a basis: (band, diffusion-output, HKS) max relative
    errors (the JAX package's bench_large.eigensolver_parity_errs)."""
    dh = _spectral_diffusion(ev_h, evec_h, mass, x, ts)
    dd = _spectral_diffusion(ev_d, evec_d, mass, x, ts)
    diff = max(float(np.abs(b - a).max() / (np.abs(a).max() + 1e-30))
               for a, b in zip(dh, dd))
    hks_h = (evec_h ** 2) @ np.exp(-np.asarray(ev_h)[:, None] * ts[None, :])
    hks_d = (evec_d ** 2) @ np.exp(-np.asarray(ev_d)[:, None] * ts[None, :])
    hks = float(np.abs(hks_d - hks_h).max() / (np.abs(hks_h).max() + 1e-30))
    band = float(np.abs(ev_d - ev_h).max() / (ev_h.max() + 1e-30))
    return band, diff, hks


def section_eigen(n: int = 142, k_eig: int = 128, device: str = "cuda",
                  out_dir: str = OUT_DIR) -> None:
    """The port's device solver (the compute_operators default: sweeps and
    the f64 polish) against the ARPACK ladder on flat_grid(n, jitter 0.4),
    20,164 vertices at n 142, on `device` (cuda raises without a card)."""
    import torch
    from ...geometry.eigen import eigensolve_device, eigensolve_host
    from ...geometry.laplacian import cotan_laplacian, vertex_areas
    from ...ops.sparse import ell_from_coo

    on_card = torch.device(device).type == "cuda"
    if on_card and not torch.cuda.is_available():
        raise RuntimeError("section eigen: no CUDA card is visible to "
                           "torch; pass --device cpu to run on the CPU")
    verts, faces = flat_grid(n, jitter=0.4)
    V = verts.shape[0]
    L = cotan_laplacian(verts, faces)
    mass = vertex_areas(verts, faces)
    mass = mass + 1e-8 * np.mean(mass)
    coo = L.tocoo()
    ell = ell_from_coo(coo.row, coo.col, coo.data, V)
    m32 = mass.astype(np.float32)

    def timed(fn):
        if on_card:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        if on_card:
            torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    (_, _), t_cold = timed(lambda: eigensolve_device(ell, m32, k_eig,
                                                     device=device))
    (ev_d, evec_d), t_dev = timed(lambda: eigensolve_device(
        ell, m32, k_eig, device=device))
    (ev_p, evec_p), t_pol = timed(lambda: eigensolve_device(
        ell, m32, k_eig, polish=(L, mass), device=device))
    (ev_h, evec_h), t_host = timed(lambda: eigensolve_host(L, mass, k_eig))
    x = np.random.RandomState(0).randn(V, 4)
    ts = np.logspace(-3, 0, 6) / max(ev_h[1], 1e-12)
    f32 = parity_errs(ev_h, evec_h, ev_d.cpu().double().numpy(),
                      evec_d.cpu().double().numpy(), mass, x, ts)
    pol = parity_errs(ev_h, evec_h, ev_p, evec_p, mass, x, ts)
    _write_jsonl("eigensolver", [{
        "metric": f"device eigensolve @ {V} verts, k={k_eig} (device sweeps "
                  "+ f64 polish)",
        "device": str(device), "card": card_line() if on_card else NO_CARD,
        "band_max_rel_err": pol[0], "diffusion_output_max_rel_err": pol[1],
        "hks_max_rel_err": pol[2],
        "f32_band_max_rel_err": f32[0],
        "f32_diffusion_output_max_rel_err": f32[1],
        "device_s": round(t_pol, 3), "sweeps_only_s": round(t_dev, 3),
        "first_call_s": round(t_cold, 3), "arpack_s": round(t_host, 3),
    }], out_dir)


PARITY_TESTS = ("tests/test_torch_convert_checkpoint.py",)


def parse_pytest_summary(out: str) -> dict:
    """The counts of pytest's last summary line (passed, failed, skipped,
    errors)."""
    counts = {}
    lines = [ln for ln in out.splitlines()
             if re.search(r"\d+ (passed|failed|skipped|error)", ln)]
    for n, what in re.findall(r"(\d+) (passed|failed|skipped|errors?)",
                              lines[-1] if lines else ""):
        counts["errors" if what.startswith("error") else what] = int(n)
    return counts


def section_parity(out_dir: str = OUT_DIR) -> None:
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-rs", *PARITY_TESTS],
        cwd=REPO, capture_output=True, text=True, timeout=3600)
    out = proc.stdout + proc.stderr
    rec = {"suite": " ".join(PARITY_TESTS), "returncode": proc.returncode,
           "card": card_line(), **parse_pytest_summary(out)}
    if proc.returncode != 0:
        print(out[-3000:])
        raise SectionFailed(f"pytest exited {proc.returncode}")
    if rec.get("skipped"):
        rec["note"] = "skipped: reference checkpoints absent"
    _write_jsonl("pretrained_parity", [rec], out_dir)


def parse_example(out: str, patterns: dict[str, str]) -> dict:
    """The last match of each pattern in an example's output, as float."""
    rec = {}
    for key, pat in patterns.items():
        matches = re.findall(pat, out)
        if matches:
            rec[key] = float(matches[-1])
    return rec


def _run_example(module: str, args: list[str], patterns: dict[str, str],
                 timeout: int = 5400) -> dict:
    cmd = [sys.executable, "-m", f"diffusionnet_tpu_torch.examples.{module}",
           *args]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                          timeout=timeout)
    out = proc.stdout + proc.stderr
    rec = {"script": f"diffusionnet_tpu_torch.examples.{module}",
           "args": " ".join(args), "returncode": proc.returncode,
           "wall_s": round(time.perf_counter() - t0, 1),
           "card": card_line(), **parse_example(out, patterns)}
    if proc.returncode != 0:
        print(out[-3000:])
        raise SectionFailed(f"{module} exited {proc.returncode}")
    return rec


SHREC_ACC = {"test_accuracy_pct": r"Overall test accuracy:\s*([\d.]+)%"}


def section_synthetic(device: str = "cuda", out_dir: str = OUT_DIR) -> None:
    dev = ["--device", device]
    records = [
        _run_example("synthetic_shrec", ["--n_epoch", "40", *dev], SHREC_ACC),
        _run_example("fmaps_synthetic", dev,
                     {"heldout_fmap_l2":
                      r"held-out pair: fmap L2 ([\d.e+-]+)"}),
        _run_example("sampling_invariance_synthetic",
                     ["--gate", "--out", "", *dev],
                     {"last_exact_label_acc_pct":
                      r"exact-label acc\s+([\d.]+)%",
                      "last_mean_angular_err_deg":
                      r"mean angular err\s+([\d.]+) deg"}),
    ]
    _write_jsonl("synthetic", records, out_dir)


def section_soak(device: str = "cuda", out_dir: str = OUT_DIR) -> None:
    rec = _run_example(
        "synthetic_shrec",
        ["--n_epoch", "200", "--per_class", "10", "--mega", "--bf16",
         "--device", device], SHREC_ACC)
    rec["config"] = ("the E1 example at the reference schedule, 200 epochs, "
                     "megakernel + bf16 (the full-schedule stability soak)")
    _write_jsonl("soak", [rec], out_dir)


def _on(r: dict) -> str:
    return f"[{r.get('card', NO_CARD)}]"


def render(out_dir: str = OUT_DIR, path: str = RENDERED) -> str:
    """docs/RESULTS_TORCH.md from the jsonl files of out_dir; returns the
    text."""
    lines = [
        "# Results of the PyTorch/CUDA port",
        "",
        "Generated by `python -m diffusionnet_tpu_torch.experiments.tools."
        "gen_results` from `docs/results_torch/*.jsonl` (regenerate a "
        "section with `--sections <name>,render`). Every number stands "
        "beside the card it was measured on (`nvidia-smi --query-gpu=name,"
        "power.limit`; `cpu` where there was none). The JAX package's "
        "results are in docs/RESULTS.md and are not the port's.",
        "",
        "## Benchmark",
        "",
    ]
    bench = _read_jsonl("bench", out_dir)
    if not bench:
        lines += ["No port benchmark yet.", ""]
    for r in bench:
        lines.append(f"- {r.get('artifact', '')}: {r.get('metric', '')} "
                     f"{r.get('value', '')} {r.get('unit', '')} {_on(r)}")
    if bench:
        lines.append("")

    eig = _read_jsonl("eigensolver", out_dir)
    if eig:
        lines += ["## Device eigensolver against ARPACK", "",
                  "Gauge-invariant parity of the device solver (sweeps and "
                  "the f64 polish, the compute_operators default) against "
                  "the ARPACK ladder; the JAX package's gate is 1e-4.", ""]
        for r in eig:
            lines.append(
                f"- {r['metric']} on {r['device']} {_on(r)}: band "
                f"{r['band_max_rel_err']:.2e}, diffusion outputs "
                f"{r['diffusion_output_max_rel_err']:.2e}, HKS "
                f"{r['hks_max_rel_err']:.2e} (f32 sweeps alone: band "
                f"{r['f32_band_max_rel_err']:.2e}, diffusion "
                f"{r['f32_diffusion_output_max_rel_err']:.2e}); device "
                f"{r['device_s']} s (sweeps alone {r['sweeps_only_s']} s, "
                f"first call {r['first_call_s']} s) against ARPACK "
                f"{r['arpack_s']} s")
        lines.append("")

    par = _read_jsonl("pretrained_parity", out_dir)
    if par:
        lines += ["## Checkpoint conversion and parity", ""]
        for r in par:
            counts = ", ".join(f"{r[k]} {k}" for k in
                               ("passed", "failed", "skipped", "errors")
                               if k in r)
            note = f"; {r['note']}" if "note" in r else ""
            lines.append(f"- `{r['suite']}`: {counts or 'no tests ran'} "
                         f"(rc={r['returncode']}){note} {_on(r)}")
        lines.append("")

    syn = _read_jsonl("synthetic", out_dir)
    if syn:
        lines += ["## Synthetic end-to-end examples", "",
                  "The port's examples on parametric shape families (the "
                  "real datasets need downloads).", ""]
        for r in syn:
            kv = ", ".join(f"{k}={v}" for k, v in r.items()
                           if k not in ("script", "args", "generated_utc",
                                        "card"))
            lines.append(f"- `{r['script']} {r['args']}`: {kv} {_on(r)}")
        lines.append("")

    soak = _read_jsonl("soak", out_dir)
    if soak:
        lines += ["## Full-schedule soak", ""]
        for r in soak:
            lines.append(f"- `{r['script']} {r['args']}`: test accuracy "
                         f"{r.get('test_accuracy_pct', '?')}%, wall "
                         f"{r.get('wall_s', '?')} s (rc={r['returncode']}) "
                         f"{_on(r)}: {r.get('config', '')}")
        lines.append("")

    lines += ["## Provenance", "",
              "Each jsonl record carries `generated_utc` and `card`.", ""]
    text = "\n".join(lines)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(text)
    print(f"wrote {os.path.relpath(path, REPO)}")
    return text


def section_render() -> None:
    render()


SECTIONS = ("bench", "eigen", "parity", "synthetic", "soak", "render")
ON_DEVICE = ("eigen", "synthetic", "soak")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--sections", default="bench,render",
                    help="comma list: " + ",".join(SECTIONS))
    ap.add_argument("--device", default="cuda",
                    help="where eigen, synthetic and soak run (cpu or cuda)")
    args = ap.parse_args(argv)
    names = [s.strip() for s in args.sections.split(",")]
    for s in names:
        if s not in SECTIONS:
            raise SystemExit(f"unknown section '{s}'")
    failed = []
    for s in names:
        kw = {"device": args.device} if s in ON_DEVICE else {}
        try:
            globals()[f"section_{s}"](**kw)
        except SectionFailed as e:
            failed.append(f"{s} ({e})")
    if failed:
        raise SystemExit("failed sections, no record written: "
                         + ", ".join(failed))


if __name__ == "__main__":
    main()
