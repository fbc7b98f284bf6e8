"""The port's deployed-conditions calibration (`profiling/measure_deployed.py`)
and the trace modules it needs (`core/job.py`, `core/trace.py`), against
the JAX package's.

`parse_rounds` of the reference script and of the port must give the
same records on the same iterator logs (a one-rank round, and a gang's
two ranks), and must read a round log that the port's own
`LeaseIterator` writes. The port's `Job` and trace parser must read every
line of the canonical trace as the reference's do and write it back as
the reference's writer does (byte for byte but for the arrival time,
which the file writes as an integer). Then the script itself on the CPU: the unchanged
`scripts/drivers/run_physical.py` and the port's worker as subprocesses,
two small jobs alternating over short rounds, and every key it writes;
its refusals of what needs more than one card, and of a missing card.
The `cuda` twin runs the loopback on the card.
"""
import importlib.util
import json
import os
import socket

import pytest
import torch

from shockwave_tpu.core import trace as ref_trace
from shockwave_tpu_torch.core import trace as port_trace
from shockwave_tpu_torch.profiling import measure_deployed as md
from shockwave_tpu_torch.profiling.measure_throughput import GANG_ITEM

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CANONICAL_TRACE = os.path.join(REPO, "data", "canonical_120job.trace")
# The fixture log of tests/test_scripts.py::TestMeasureDeployedParser.
ROUND_LOG = ("[2026-07-30 10:00:00] [PROGRESS] [STEPS] 0\n"
             "[2026-07-30 10:00:00] [LOAD CHECKPOINT] [BEGIN] \n"
             "[2026-07-30 10:00:01] [LOAD CHECKPOINT] [END] \n"
             "[2026-07-30 10:02:00] [LEASE] [EXPIRED] 31 / 70 steps, "
             "104.6354 / 104.6354 seconds\n"
             "[2026-07-30 10:02:02] [SAVE CHECKPOINT] [BEGIN] \n"
             "[2026-07-30 10:02:03] [SAVE CHECKPOINT] [END] \n")
DEPLOYED_KEYS = ("lease_shortfall_s", "lease_shortfall_s_by_type", "round_drain_s",
                 "round_drain_s_by_type", "deployed_calibration")


def reference_script():
    spec = importlib.util.spec_from_file_location(
        "ref_measure_deployed", os.path.join(REPO, "scripts", "profiling", "measure_deployed.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def write_log(root, job, rnd, worker, text):
    log_dir = root / f"job_id={job}" / ".swtpu" / f"round={rnd}"
    log_dir.mkdir(parents=True, exist_ok=True)
    (log_dir / f"worker={worker}.log").write_text(text)


def shifted(text, seconds, steps, duration):
    """ROUND_LOG with its times moved by `seconds` and its lease line
    reporting `steps` in `duration` seconds."""
    import datetime
    out = []
    for line in text.splitlines(keepends=True):
        stamp = datetime.datetime.strptime(line[1:20], md.LOG_TS)
        line = "[" + (stamp + datetime.timedelta(seconds=seconds)).strftime(md.LOG_TS) + line[20:]
        out.append(line.replace("31 / 70 steps, 104.6354 / 104.6354",
                                f"{steps} / 70 steps, {duration} / {duration}"))
    return "".join(out)


class TestParseRounds:
    def test_one_round_matches_the_reference(self, tmp_path):
        write_log(tmp_path, 0, 1, 0, ROUND_LOG)
        recs = md.parse_rounds(str(tmp_path))
        assert recs == reference_script().parse_rounds(str(tmp_path))
        [(rnd, load, _, save_end, steps, dur)] = recs
        assert (rnd, steps, dur) == (1, 31, 104.6354)
        assert (save_end - load).total_seconds() == 122.0

    def test_a_gangs_ranks_match_the_reference(self, tmp_path):
        """Two jobs over three rounds; job 1 a gang whose two ranks log the
        same rounds at other times and step counts (steps sum, the
        slowest rank's duration, the earliest load, the last save), one
        rank without a lease line, and a log with no load (skipped)."""
        write_log(tmp_path, 0, 0, 0, shifted(ROUND_LOG, 0, 30, 100.5))
        write_log(tmp_path, 1, 1, 0, shifted(ROUND_LOG, 130, 12, 90.25))
        write_log(tmp_path, 1, 1, 1, shifted(ROUND_LOG, 131, 14, 95.0))
        write_log(tmp_path, 0, 2, 0, shifted(ROUND_LOG, 260, 33, 101.0))
        write_log(tmp_path, 1, 3, 0, shifted(ROUND_LOG, 390, 10, 80.0))
        write_log(tmp_path, 1, 3, 1, "\n".join(ROUND_LOG.splitlines()[:3]) + "\n")
        write_log(tmp_path, 0, 4, 0, "[2026-07-30 10:00:00] [PROGRESS] [STEPS] 0\n")
        recs = md.parse_rounds(str(tmp_path))
        assert recs == reference_script().parse_rounds(str(tmp_path))
        assert [(r[0], r[4], r[5]) for r in recs] == [
            (0, 30, 100.5), (1, 26, 95.0), (2, 33, 101.0), (3, 10, 80.0)]

    def test_reads_the_port_iterators_round_log(self, tmp_path, monkeypatch):
        """The port's `LeaseIterator`, under a stub scheduler granting 5
        steps, loads, trains until the lease expires and saves: its round
        log gives one record with the 5 steps and their in-lease time."""
        from shockwave_tpu.runtime.servers import serve_scheduler
        from shockwave_tpu_torch.runtime.iterator import LeaseIterator
        with socket.socket() as s:
            s.bind(("", 0))
            port = s.getsockname()[1]
        for key, value in {"SWTPU_JOB_ID": "3", "SWTPU_WORKER_ID": "0", "SWTPU_ROUND_ID": "2",
                           "SWTPU_SCHED_ADDR": "localhost",
                           "SWTPU_SCHED_PORT": str(port)}.items():
            monkeypatch.setenv(key, value)
        for key in ("SWTPU_RUNAHEAD_STEPS", "SWTPU_DEGRADE_FACTOR", "SWTPU_SPAN_SHARD_DIR",
                    "SWTPU_TRACEPARENT", "SWTPU_HA_ENDPOINT_FILE"):
            monkeypatch.delenv(key, raising=False)
        server = serve_scheduler(port, {
            "RegisterWorker": lambda **kw: ([0], 60.0), "Done": lambda *a: None,
            "InitJob": lambda job_id: (5, 1e6, 0.0),
            "UpdateLease": lambda *a, **kw: (5, 1e6, 0.0, 1e9)})
        try:
            it = LeaseIterator(data_loader=list(range(100)),
                               checkpoint_dir=str(tmp_path / "job_id=3"),
                               load_checkpoint_func=lambda path: None,
                               save_checkpoint_func=lambda path: None)
            it.load_checkpoint("ckpt")
            steps = sum(1 for _ in it)
            it.save_checkpoint("ckpt")
            it.close()
        finally:
            server.stop(grace=0)
        [(rnd, load, exp, save_end, got, dur)] = md.parse_rounds(str(tmp_path))
        assert (rnd, got, steps) == (2, 5, 5)
        assert load <= exp <= save_end and 0 <= dur < 60


class TestTraceParity:
    def test_the_canonical_trace_reads_and_writes_as_the_reference(self):
        port_jobs, port_arrivals = port_trace.parse_trace(CANONICAL_TRACE)
        ref_jobs, ref_arrivals = ref_trace.parse_trace(CANONICAL_TRACE)
        assert len(port_jobs) == 120 and port_arrivals == ref_arrivals
        fields = ("job_type", "command", "working_directory", "num_steps_arg", "total_steps",
                  "duration", "scale_factor", "mode", "priority_weight", "SLO",
                  "needs_data_dir", "mps_thread_percentage", "model", "batch_size")
        for ours, ref in zip(port_jobs, ref_jobs):
            assert {f: getattr(ours, f) for f in fields} == {f: getattr(ref, f) for f in fields}
        # Written back: the first 11 fields byte for byte; the file writes
        # its arrival times as integers, the writer (both packages') as
        # "%f", so the arrival is compared as a number.
        with open(CANONICAL_TRACE) as f:
            lines = [line.rstrip("\n") for line in f if line.strip()]
        for job, arrival, line, ref in zip(port_jobs, port_arrivals, lines, ref_jobs):
            written = port_trace.job_to_trace_line(job, arrival)
            assert written == ref_trace.job_to_trace_line(ref, arrival)
            *fields, when = written.split("\t")
            *want, want_when = line.split("\t")
            assert fields == want and float(when) == float(want_when)

    def test_update_bs_rewrites_as_the_reference(self):
        from shockwave_tpu.core.job import Job as RefJob
        from shockwave_tpu_torch.core.job import Job
        for job_type, command in (
                ("LM (batch size 20)", "python3 main.py --cuda --data %s/wikitext2 --batch_size 20"),
                ("Transformer (batch size 64)", "python3 train.py -data %s/translation/m.pt "
                 "-batch_size 64 -proj_share_weight")):
            ours, ref = Job(None, job_type, command), RefJob(None, job_type, command)
            ours.update_bs(40)
            ref.update_bs(40)
            assert (ours.job_type, ours.command) == (ref.job_type, ref.command)


class TestMeasureDeployed:
    FAMILY = "Recommendation (batch size 512)"

    @pytest.mark.timeout(240)
    def test_cpu_loopback_writes_every_key(self, tmp_path, monkeypatch):
        """Two Recommendation jobs at batch 512 on the CPU (`--device
        cpu`, one torch thread each), three rounds of 10 s: the family's
        rate row becomes its deployed rate, with its solo rate and the
        leases beside it, and the shortfall and drain keys are written,
        the shortfall within [0, round)."""
        monkeypatch.setenv("OMP_NUM_THREADS", "1")
        oracle = tmp_path / "oracle.json"
        oracle.write_text(json.dumps({
            "cpu": {f"('{self.FAMILY}', 1)": {"null": 3.0},
                    "('LM (batch size 20)', 1)": {"null": 1.5}},
            "__meta__": {"dispatch_overhead_s": {"cpu": 9.0}}}))
        md.main(["--worker_type", "cpu", "--oracle", str(oracle), "--families", self.FAMILY,
                 "--round_duration", "10", "--rounds", "3", "--timeout", "120",
                 "--device", "cpu", "--data_dir", str(tmp_path / "data")])
        written = json.loads(oracle.read_text())
        meta = written["__meta__"]
        assert all("cpu" in meta[key] for key in DEPLOYED_KEYS)
        assert meta["dispatch_overhead_s"] == {"cpu": 9.0}  # measure_startup's key stays
        record = meta["deployed_calibration"]["cpu"]["sf=1"]
        detail = record["per_family"][self.FAMILY]
        rate = written["cpu"][f"('{self.FAMILY}', 1)"]["null"]
        assert rate > 0 and detail["deployed_steps_per_s"] == rate
        assert detail["solo_steps_per_s"] == 3.0 and detail["leases"] >= 1
        assert written["cpu"]["('LM (batch size 20)', 1)"] == {"null": 1.5}
        shortfall = meta["lease_shortfall_s_by_type"]["cpu"][self.FAMILY]
        assert 0 <= shortfall < 10 and meta["lease_shortfall_s"]["cpu"] == shortfall
        assert meta["round_drain_s"]["cpu"] == meta["round_drain_s_by_type"]["cpu"][self.FAMILY]
        assert record["round_duration"] == 10.0
        # The reference's simulator reads the file back.
        from shockwave_tpu.core.oracle import read_oracle
        rows, read_meta = read_oracle(str(oracle))
        assert read_meta["lease_shortfall_s"] == {"cpu": shortfall}

    def test_a_second_calibration_keeps_the_solo_rate(self):
        oracle = {"cpu": {f"('{self.FAMILY}', 1)": {"null": 5.5}},
                  "__meta__": {"deployed_calibration": {"cpu": {"sf=1": {"per_family": {
                      self.FAMILY: {"deployed_steps_per_s": 5.5, "solo_steps_per_s": 7.0}}}}}}}
        assert md.solo_rate(oracle, "cpu", self.FAMILY) == 7.0
        assert md.solo_rate(oracle, "cpu", "LM (batch size 20)") == 0.2
        del oracle["__meta__"]["deployed_calibration"]
        assert md.solo_rate(oracle, "cpu", self.FAMILY) == 5.5

    @pytest.mark.parametrize("argv,flag", [(["--scale_factor", "2"], "--scale_factor 2"),
                                           (["--concurrent"], "--concurrent")])
    def test_what_needs_more_than_one_card_is_refused(self, argv, flag, capsys, tmp_path):
        with pytest.raises(SystemExit) as exit_info:
            md.main(["--worker_type", "h100", "--oracle", str(tmp_path / "none.json"), *argv])
        assert exit_info.value.code == 2
        err = capsys.readouterr().err
        assert flag in err and GANG_ITEM in err and "more than one card" in err

    def test_no_card_is_refused_rather_than_run_on_the_cpu(self, tmp_path, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(SystemExit, match="no CUDA device"):
            md.main(["--worker_type", "h100", "--oracle", str(tmp_path / "none.json")])

    def test_unknown_job_types_are_refused(self, tmp_path):
        with pytest.raises(SystemExit, match="unknown job types"):
            md.main(["--worker_type", "cpu", "--oracle", str(tmp_path / "none.json"),
                     "--device", "cpu", "--families", "GPT (batch size 1)"])

    @pytest.mark.cuda
    def test_h100_loopback(self, tmp_path):
        """The same drive on the card: LM (batch size 20) from a copy of
        data/h100_throughputs.json, three rounds of 40 s. Run it with
        `python -m pytest --noconftest -m cuda tests/test_torch_measure_deployed.py -s`."""
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA card")
        family = "LM (batch size 20)"
        oracle = tmp_path / "h100_throughputs.json"
        oracle.write_text(open(os.path.join(REPO, "data", "h100_throughputs.json")).read())
        md.main(["--worker_type", "h100", "--oracle", str(oracle), "--families", family,
                 "--round_duration", "40", "--rounds", "3", "--timeout", "600"])
        written = json.loads(oracle.read_text())
        detail = written["__meta__"]["deployed_calibration"]["h100"]["sf=1"]["per_family"][family]
        shortfall = written["__meta__"]["lease_shortfall_s_by_type"]["h100"][family]
        assert detail["leases"] >= 1 and detail["deployed_steps_per_s"] > 0
        assert 0 <= shortfall < 40
        print("h100_deployed:", json.dumps({"detail": detail, "shortfall_s": shortfall}))
