"""The port's regression sentinel and ``edl_report`` against the JAX
package's (``edl_tpu/obs/regress.py``, ``tools/edl_report.py``).

- ``tests/test_report.py``'s ``TestSentinel`` cases run through both
  ``regress`` modules, each with its own ``Metric`` table, and the two
  give equal verdicts.
- Its ``TestReportCLI`` cases run both CLIs (``main`` in this process)
  over ONE archive whose bundles alternate between the JAX and the port
  ``RunArchive``: both exit alike and print equal JSON (the only allowed
  difference, the table's headline row, is renamed before comparing).
- The port's own table: the headline row is the port's bench metric
  (``resnet50_vd_train_throughput_gpu``), every other row is the JAX
  table's, and the floors are bars; ``--import-legacy`` keeps the backend
  its files name, so a TPU row never judges a ``cuda`` run.
"""

import io
import json
import os
import subprocess
import sys
from contextlib import redirect_stdout

import pytest

import test_report as tr
from edl_tpu.obs import archive as jax_archive
from edl_tpu.obs import regress as jax_regress
from edl_tpu_torch.obs import archive as port_archive
from edl_tpu_torch.obs import regress as port_regress
from edl_tpu_torch.tools import edl_report as port_report

import edl_report as jax_report  # tools/, put on sys.path by test_report

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REGRESS = {"jax": jax_regress, "port": port_regress}
HEADLINE = {"jax": "resnet50_vd_train_throughput_tpu",
            "port": "resnet50_vd_train_throughput_gpu"}
_row = tr._row


# -- the sentinel, through both modules ----------------------------------------


def _table(regress, *specs):
    return [regress.Metric(*a, **k) for a, k in specs]


DOWNTIME = (("resize_downtime", "lower", 0.25), {})


def _judge(rows, *specs, k=5):
    """Both modules' ``evaluate_latest``; asserts they agree and returns
    the port's."""
    out = {name: reg.evaluate_latest(rows, metrics=_table(reg, *specs), k=k)
           for name, reg in REGRESS.items()}
    assert out["port"] == out["jax"]
    return out["port"]


def test_green_within_tolerance():
    entries, ok = _judge([_row(2.0), _row(2.1), _row(2.2)], DOWNTIME)
    assert ok
    (v,) = entries[0]["verdicts"]
    assert v["verdict"] == "ok" and v["n_baseline"] == 2


@pytest.mark.parametrize("case", ["regressed", "higher", "improved"])
def test_red_on_regression_and_improved(case):
    if case == "regressed":
        entries, ok = _judge([_row(2.0), _row(2.0), _row(3.5)], DOWNTIME)
        assert not ok
        assert entries[0]["verdicts"][0]["verdict"] == "regressed"
    elif case == "higher":
        # direction matters: the same drop on a higher-is-better metric
        rows = [_row(0.9, "goodput_ratio"), _row(0.5, "goodput_ratio")]
        _, ok = _judge(rows, (("goodput_ratio", "higher", 0.1), {}))
        assert not ok
    else:
        entries, ok = _judge([_row(2.0), _row(2.0), _row(1.0)], DOWNTIME)
        assert ok
        assert entries[0]["verdicts"][0]["verdict"] == "improved"


def test_insufficient_baseline():
    entries, ok = _judge([_row(2.0), _row(9.0)],
                         (("resize_downtime", "lower", 0.25),
                          {"min_samples": 3}))
    assert ok  # a first run has nothing to regress against
    assert entries[0]["verdicts"][0]["verdict"] == "insufficient-baseline"


def test_baseline_hygiene_excluded_stale_red():
    rows = [_row(2.0), _row(0.0, excluded=True), _row(50.0, stale=True),
            _row(50.0, ok=False), _row(2.1)]
    entries, ok = _judge(rows, DOWNTIME)
    assert ok
    (v,) = entries[0]["verdicts"]
    assert v["n_baseline"] == 1 and v["baseline"] == 2.0
    # the newest row being unusable: judge the newest USABLE one
    rows.append(_row(99.0, stale=True))
    entries, ok = _judge(rows, DOWNTIME)
    assert ok and entries[0]["verdicts"][0]["value"] == 2.1


def test_rolling_window_k():
    rows = [_row(10.0)] + [_row(2.0) for _ in range(5)] + [_row(2.2)]
    entries, ok = _judge(rows, DOWNTIME)
    # the k=5 window dropped the ancient 10.0: baseline is 2.0
    assert ok and entries[0]["verdicts"][0]["baseline"] == 2.0


def test_keys_never_cross():
    entries, ok = _judge([_row(2.0), _row(9.0, world=4)], DOWNTIME)
    assert ok  # different world = different key = no baseline
    keys = {tuple(e["key"]) for e in entries}
    assert keys == {("resize_bench", "cpu", 2), ("resize_bench", "cpu", 4)}
    # nor do backends: a TPU row is no baseline of a cuda run
    rows = [_row(2.0, backend="tpu"), _row(9.0, backend="cuda")]
    entries, ok = _judge(rows, DOWNTIME)
    assert ok and {tuple(e["key"]) for e in entries} == {
        ("resize_bench", "tpu", 2), ("resize_bench", "cuda", 2)}


def test_live_run_judged_over_late_appended_legacy():
    rows = [_row(2.0, legacy=True, source="old_r1.json"), _row(2.1),
            _row(50.0, legacy=True, source="old_r2.json")]
    entries, _ok = _judge(rows, DOWNTIME)
    (v,) = entries[0]["verdicts"]
    assert v["value"] == 2.1          # the live run, not legacy r2
    assert v["n_baseline"] == 2       # both legacy rows are baseline


def test_absolute_floor_band():
    spec = (("per_chip_loss_pct", "lower", 0.5), {"floor": 5.0})
    rows = [_row(-0.5, "per_chip_loss_pct"), _row(4.8, "per_chip_loss_pct")]
    entries, ok = _judge(rows, spec)
    assert ok and entries[0]["verdicts"][0]["verdict"] == "ok"
    rows.append(_row(9.0, "per_chip_loss_pct"))
    _, ok = _judge(rows, spec)
    assert not ok


@pytest.mark.parametrize("pkg", sorted(REGRESS))
def test_tolerance_overrides_parse(pkg):
    regress = REGRESS[pkg]
    over = regress.tolerance_overrides("restage_s=0.5, mfu=0.02,bad")
    assert over == {"restage_s": 0.5, "mfu": 0.02}
    table = regress.metrics_table(overrides={"mfu": 0.5})
    assert next(m for m in table if m.name == "mfu").tolerance == 0.5


def test_port_table_gates_the_ports_headline():
    """The JAX table's rows, with the headline renamed to the port's
    bench metric and the floors that were rig measurements changed to
    the bars they stand for; a halved headline on a cuda key regresses."""
    jax_rows = {m.name: m for m in jax_regress.builtin_metrics()}
    port_rows = {m.name: m for m in port_regress.builtin_metrics()}
    assert set(port_rows) == (set(jax_rows) - {HEADLINE["jax"]}) | {
        HEADLINE["port"]}
    floors = {n: m.floor for n, m in port_rows.items() if m.floor is not None}
    assert floors == {"per_chip_loss_pct": 5.0, "convergence_churn_gap": 0.3,
                      "numerics_probe_overhead_pct": 2.0,
                      "serve_shed_pct": 5.0,
                      "autoscale_goodput_loss_pct": 65.0}
    for name, m in port_rows.items():
        if name in jax_rows:
            want = jax_rows[name].to_dict()
            if name not in ("autoscale_goodput_loss_pct",
                            "hbm_plan_accuracy_pct"):
                assert m.to_dict() == want, name
            else:
                assert {k: v for k, v in m.to_dict().items() if k != "floor"
                        } == {k: v for k, v in want.items() if k != "floor"}
    head = port_rows[HEADLINE["port"]].to_dict()
    assert head == dict(jax_rows[HEADLINE["jax"]].to_dict(),
                        name=HEADLINE["port"])
    rows = [_row(3250.0, HEADLINE["port"], kind="bench", backend="cuda",
                 world=None),
            _row(1625.0, HEADLINE["port"], kind="bench", backend="cuda",
                 world=None)]
    entries, ok = port_regress.evaluate_latest(rows)
    assert not ok
    (v,) = entries[0]["verdicts"]
    assert (v["metric"], v["verdict"]) == (HEADLINE["port"], "regressed")


# -- the CLI: both tools over one archive written by both RunArchives ----------


ARCHIVES = (jax_archive, port_archive)


def archive_pair(root, restage_a=2.0, restage_b=2.1):
    """Two resize_bench runs of one key, the first archived by the JAX
    package's ``RunArchive``, the second by the port's."""
    bundles = []
    for i, restage in enumerate((restage_a, restage_b)):
        scratch = os.path.join(root, "..", "scratch-%d" % i)
        flight, traces = tr.make_run_dirs(scratch, restage_s=restage)
        bundles.append(ARCHIVES[i % 2].RunArchive(root).archive(
            "resize_bench", "cpu", backend="cpu", world=2, seed=0,
            flight_dir=flight, trace_dir=traces,
            bench=tr.resize_bench_doc(restage)))
    return bundles


def _call(tool, args):
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = tool.main(args)
    return rc, buf.getvalue()


def run_cli(args):
    """Both CLIs on ``args``: equal exit codes and equal output (JSON
    compared as documents, the JAX headline row renamed); the port's
    ``(rc, stdout)``."""
    rc_j, out_j = _call(jax_report, args)
    rc_p, out_p = _call(port_report, args)
    assert rc_p == rc_j, (args, rc_p, rc_j)
    if "--json" in args and out_p.strip():
        out_j = out_j.replace(HEADLINE["jax"], HEADLINE["port"])
        assert json.loads(out_p) == json.loads(out_j), args
    else:
        assert out_p == out_j, args
    return rc_p, out_p


def test_check_exit_codes_and_json_shape(tmp_path):
    root = str(tmp_path / "runs")
    archive_pair(root, 2.0, 2.1)
    rc, out = run_cli(["--runs", root, "--check", "--json"])
    assert rc == 0
    doc = json.loads(out)
    assert doc["ok"] is True and doc["metric"] == "edl_report_check"
    assert doc["runs"][0]["key"] == ["resize_bench", "cpu", 2]
    verdicts = {v["metric"]: v for v in doc["runs"][0]["verdicts"]}
    assert verdicts["resize_downtime"]["verdict"] == "ok"
    # the deliberate slowdown: a third run 3x slower must gate
    flight, traces = tr.make_run_dirs(str(tmp_path / "scratch-red"),
                                      restage_s=6.0)
    port_archive.RunArchive(root).archive(
        "resize_bench", "cpu", backend="cpu", world=2,
        flight_dir=flight, trace_dir=traces,
        bench=tr.resize_bench_doc(6.0))
    rc, out = run_cli(["--runs", root, "--check", "--json"])
    assert rc == 1
    doc = json.loads(out)
    assert doc["ok"] is False and doc["value"] >= 1
    regressed = [v["metric"] for e in doc["runs"] for v in e["verdicts"]
                 if v["verdict"] == "regressed"]
    assert "resize_downtime" in regressed


def test_check_empty_archive_is_green(tmp_path):
    rc, out = run_cli(["--runs", str(tmp_path / "none"), "--check", "--json"])
    assert rc == 0 and json.loads(out)["ok"] is True


def test_cli_reads_with_archiving_disabled(tmp_path, monkeypatch):
    monkeypatch.setenv("EDL_RUN_ARCHIVE", "0")
    monkeypatch.chdir(tmp_path)
    rc, out = run_cli(["--list", "--json"])
    assert rc == 0 and json.loads(out)["runs"] == []
    rc, out = run_cli(["--check", "--json"])
    assert rc == 0 and json.loads(out)["ok"] is True


def test_list_and_show_json(tmp_path):
    root = str(tmp_path / "runs")
    bundles = archive_pair(root)
    rc, out = run_cli(["--runs", root, "--list", "--json"])
    assert rc == 0
    rows = json.loads(out)["runs"]
    assert [r["bundle"] for r in rows] == [
        "resize_bench-cpu-0", "resize_bench-cpu-1"]
    for name in ("resize_bench-cpu-0", "resize_bench-cpu-1"):
        rc, out = run_cli(["--runs", root, "--show", name, "--json"])
        assert rc == 0
        man = json.loads(out)
        assert man["bundle"] == name
        assert "knobs" in man and "rollups" in man
    rc, _ = run_cli(["--runs", root, "--show", bundles[1], "--json"])
    assert rc == 0
    rc, _ = run_cli(["--runs", root, "--show", "no-such", "--json"])
    assert rc == 2
    rc, out = run_cli(["--runs", root, "--list"])
    assert rc == 0 and "resize_bench-cpu-1" in out


def test_trend_json_and_filters(tmp_path):
    root = str(tmp_path / "runs")
    archive_pair(root, 2.0, 2.5)
    rc, out = run_cli(["--runs", root, "--trend", "restage_s", "--json"])
    assert rc == 0
    doc = json.loads(out)
    assert doc["metric"] == "restage_s"
    (series,) = doc["series"]
    assert series["key"] == ["resize_bench", "cpu", 2]
    assert [p["value"] for p in series["points"]] == [
        pytest.approx(2.0), pytest.approx(2.5)]
    rc, _ = run_cli(["--runs", root, "--trend", "restage_s", "--kind",
                     "nope"])
    assert rc == 2  # nothing matched


def test_diff_attribution_join(tmp_path):
    root = str(tmp_path / "runs")
    archive_pair(root, 2.0, 6.0)
    rc, out = run_cli(["--runs", root, "--diff", "resize_bench-cpu-0",
                       "resize_bench-cpu-1", "--json"])
    assert rc == 0
    doc = json.loads(out)
    att = doc["attribution"]
    assert att["lane"] == "restage"
    assert att["lane_delta_s"] == pytest.approx(4.0, abs=0.1)
    assert att["segment"] == "jit_compile"
    assert att["segment_delta_s"] == pytest.approx(4.0, abs=0.1)
    assert doc["rollups"]["resize_downtime"]["delta"] == pytest.approx(4.0)
    rc, _ = run_cli(["--runs", root, "--diff", "a", "b"])
    assert rc == 2


def test_module_entrypoint(tmp_path):
    root = str(tmp_path / "runs")
    archive_pair(root)
    env = dict(os.environ, PYTHONPATH=REPO)
    out = {}
    for name, module in (("jax", "tools.edl_report"),
                         ("port", "edl_tpu_torch.tools.edl_report")):
        out[name] = subprocess.run(
            [sys.executable, "-m", module, "--runs", root, "--list"],
            capture_output=True, text=True, cwd=REPO, env=env, timeout=60)
        assert out[name].returncode == 0, out[name].stderr
    assert "resize_bench-cpu-0" in out["port"].stdout
    assert out["port"].stdout == out["jax"].stdout


def test_import_legacy_keeps_the_files_backend(tmp_path):
    """The checked-in history through both importers: the same rows,
    except that a round summary's backend is the one its headline names
    (BENCH_r01 measured the CPU; the JAX importer files every summary
    under ``tpu``); a cuda run is never judged against that history."""
    src = os.path.join(REPO, "bench_results")
    rows = {}
    for name, tool in (("jax", jax_report), ("port", port_report)):
        root = str(tmp_path / name)
        rc, out = _call(tool, ["--runs", root, "--import-legacy", src,
                               "--json"])
        assert rc == 0 and json.loads(out)["value"] >= 20
        rows[name] = {r["source"]: r for r in port_archive.read_index(root)}
    assert sorted(rows["port"]) == sorted(rows["jax"])
    for source, row in rows["port"].items():
        want = dict(rows["jax"][source])
        if source == "BENCH_r01.json":
            assert want["backend"] == "tpu"
            want.update(backend="cpu", job_id="cpu")
        row, want = dict(row, ts=None), dict(want, ts=None)
        assert row == want, source
    # a cuda headline after the history: nothing in its key to judge by
    root = str(tmp_path / "port")
    port_archive.RunArchive(root).archive(
        "bench", "cuda", backend="cuda", bench={
            "metric": HEADLINE["port"], "value": 1.0})
    rc, out = _call(port_report, ["--runs", root, "--check", "--json"])
    assert rc == 0
    (entry,) = [e for e in json.loads(out)["runs"] if e["key"][1] == "cuda"]
    assert [v["verdict"] for v in entry["verdicts"]] == [
        "insufficient-baseline"]
