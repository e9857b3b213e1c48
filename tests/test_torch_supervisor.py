"""The PyTorch port's supervisor and backoff (``utils/supervisor.py``,
``utils/backoff.py``), twins of the JAX package's
``tests/test_supervisor.py``, and ``--elastic`` through the port's CLI:
a run that crashes (``crash@N``) is relaunched with ``--resume`` and ends
with the uninterrupted run's weights; the JAX CLI's refusals.
"""

import os
import subprocess
import sys
import textwrap
import time

import pytest
from click.testing import CliRunner

from pytorch_distributed_training_tpu.cli.main import main as jax_main
from pytorch_distributed_training_tpu_torch.checkpoint import (
    CheckpointManager,
)
from pytorch_distributed_training_tpu_torch.cli.main import main as cli_main
from pytorch_distributed_training_tpu_torch.utils.backoff import (
    BackoffPolicy,
)
from pytorch_distributed_training_tpu_torch.utils.supervisor import (
    HEARTBEAT_ENV, PREEMPTED_EXIT_CODE, Heartbeat, supervise,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _script(tmp_path, body):
    path = tmp_path / "child.py"
    path.write_text(textwrap.dedent(body))
    return [sys.executable, str(path)]


def _attempts(marker) -> str:
    """Child preamble: count this attempt in ``marker``; ``n`` is the
    attempt's 0-based index."""
    return f"""
        import os, sys
        path = {str(marker)!r}
        n = int(open(path).read()) if os.path.exists(path) else 0
        open(path, "w").write(str(n + 1))
    """


def test_backoff_policy_growth_and_cap():
    exact = BackoffPolicy(base_s=1.0, max_s=8.0, jitter=0.0)
    assert [exact.delay(n) for n in range(1, 7)] == [
        1.0, 2.0, 4.0, 8.0, 8.0, 8.0]
    assert BackoffPolicy(base_s=0.0, jitter=0.5).delay(3) == 0.0
    jittered = BackoffPolicy(base_s=1.0, max_s=8.0, jitter=0.5)
    for n, nominal in ((1, 1.0), (2, 2.0), (3, 4.0), (4, 8.0), (5, 8.0)):
        assert 0.5 * nominal <= jittered.delay(n) <= 1.5 * nominal
    a = BackoffPolicy(base_s=1.0, jitter=0.5, seed=7)
    b = BackoffPolicy(base_s=1.0, jitter=0.5, seed=7)
    assert [a.delay(n) for n in (1, 2, 3)] == [b.delay(n) for n in (1, 2, 3)]
    with pytest.raises(ValueError):
        BackoffPolicy(base_s=-1.0)
    with pytest.raises(ValueError):
        BackoffPolicy(jitter=1.0)
    with pytest.raises(ValueError):
        BackoffPolicy().delay(0)


def test_heartbeat_staleness(tmp_path):
    hb = Heartbeat(str(tmp_path / "hb"), timeout_s=0.2)
    assert hb.age_s() is None
    hb.beat()
    assert not hb.is_stale()
    time.sleep(0.3)
    assert hb.is_stale()


def test_supervise_restarts_until_success(tmp_path):
    marker = tmp_path / "attempts"
    argv = _script(tmp_path, _attempts(marker) + """
        if n < 2:
            sys.exit(3)
        assert "--resume" in sys.argv, sys.argv
        sys.exit(0)
    """)
    result = supervise(argv, max_restarts=5, backoff_base_s=0.0,
                       _print=lambda *a: None)
    assert (result.exit_code, result.restarts) == (0, 2)
    assert marker.read_text() == "3"


def test_supervise_gives_up(tmp_path):
    argv = _script(tmp_path, "import sys; sys.exit(7)")
    result = supervise(argv, max_restarts=2, backoff_base_s=0.0,
                       _print=lambda *a: None)
    assert (result.exit_code, result.restarts) == (7, 2)


def test_supervise_backoff_grows_exponentially_with_jitter(tmp_path):
    argv = _script(tmp_path, "import sys; sys.exit(7)")
    sleeps = []
    result = supervise(argv, max_restarts=3, backoff_base_s=1.0,
                       backoff_max_s=3.0, backoff_jitter=0.5,
                       _print=lambda *a: None, _sleep=sleeps.append)
    assert result.exit_code == 7 and len(sleeps) == 3
    for delay, nominal in zip(sleeps, (1.0, 2.0, 3.0)):
        assert 0.5 * nominal <= delay <= 1.5 * nominal


def test_supervise_preemption_exit_not_charged_against_restarts(tmp_path):
    marker = tmp_path / "attempts"
    argv = _script(tmp_path, _attempts(marker) + f"""
        if n == 0:
            sys.exit({PREEMPTED_EXIT_CODE})
        assert "--resume" in sys.argv, sys.argv
        sys.exit(0)
    """)
    sleeps = []
    result = supervise(argv, max_restarts=0, _print=lambda *a: None,
                       _sleep=sleeps.append)
    assert (result.exit_code, result.restarts, result.preemptions) == (
        0, 0, 1)
    assert sleeps == []
    assert marker.read_text() == "2"


def test_supervise_interleaved_preemptions_and_crashes(tmp_path):
    marker = tmp_path / "attempts"
    argv = _script(tmp_path, _attempts(marker) + f"""
        codes = [3, {PREEMPTED_EXIT_CODE}, 3, {PREEMPTED_EXIT_CODE}]
        if n < len(codes):
            sys.exit(codes[n])
        assert "--resume" in sys.argv, sys.argv
        sys.exit(0)
    """)
    sleeps = []
    result = supervise(argv, max_restarts=3, max_preemptions=3,
                       backoff_base_s=1.0, backoff_jitter=0.0,
                       _print=lambda *a: None, _sleep=sleeps.append)
    assert (result.exit_code, result.restarts, result.preemptions) == (
        0, 2, 2)
    assert marker.read_text() == "5"
    assert sleeps == [1.0, 2.0]


def test_supervise_preemption_loop_capped(tmp_path):
    argv = _script(tmp_path, f"import sys; sys.exit({PREEMPTED_EXIT_CODE})")
    result = supervise(argv, max_restarts=0, max_preemptions=3,
                       backoff_base_s=0.0, _print=lambda *a: None)
    assert result.exit_code == PREEMPTED_EXIT_CODE
    assert result.preemptions == 3


def test_supervise_kills_hung_child(tmp_path, monkeypatch):
    # A bare interpreter starts well inside the short heartbeat.
    monkeypatch.setenv("PYTHONPATH", "")
    marker = tmp_path / "attempts"
    argv = _script(tmp_path, _attempts(marker) + """
        import time
        if n == 0:
            time.sleep(600)  # hang without beating
        sys.exit(0)
    """)
    result = supervise(argv, max_restarts=2,
                       heartbeat_path=str(tmp_path / "hb"),
                       heartbeat_timeout_s=2.0, poll_s=0.2,
                       backoff_base_s=0.0, _print=lambda *a: None)
    assert (result.exit_code, result.hung_kills, result.restarts) == (
        0, 1, 1)


def test_supervisor_exports_heartbeat_env(tmp_path):
    argv = _script(tmp_path, f"""
        import os, sys
        sys.exit(0 if os.environ.get({HEARTBEAT_ENV!r}) else 1)
    """)
    result = supervise(argv, max_restarts=0,
                       heartbeat_path=str(tmp_path / "hb"),
                       heartbeat_timeout_s=60.0, _print=lambda *a: None)
    assert result.exit_code == 0


# --- the CLI ----------------------------------------------------------------

TINY = ["--use-cpu", "--model", "gpt2", "--dataset", "synthetic-tokens",
        "--seq-len", "16", "--model-overrides",
        "num_layers=1,hidden_dim=32,num_heads=2,vocab_size=64,max_seq_len=32",
        "--batch-size", "8", "--num-workers", "0"]


@pytest.mark.parametrize("flags,message", [
    (["--elastic"], "--elastic requires --checkpoint-dir to resume into"),
    (["--ckpt-every-steps", "2"],
     "--ckpt-every-steps requires --checkpoint-dir"),
])
def test_cli_refusals_match_the_jax_cli(flags, message, capsys):
    ref = CliRunner().invoke(jax_main, [*TINY, *flags])
    assert ref.exit_code == 2 and f"Error: {message}" in ref.output
    with pytest.raises(SystemExit) as e:
        cli_main([*TINY, *flags])
    assert e.value.code == 2
    assert f"error: {message}" in capsys.readouterr().err


def test_cli_elastic_recovers_from_a_crash(tmp_path):
    """``crash@3`` kills the child before step 3 dispatches (exit 13);
    the supervisor relaunches it with ``--resume`` and the run ends with
    the uninterrupted run's weights (the step-8 manifests), whichever step
    it resumed from (step 2's async commit may have died with the
    child)."""
    argv = [*TINY, "--steps-per-epoch", "4", "--epochs", "2",
            "--ckpt-every-steps", "2"]
    env = {**os.environ, "OMP_NUM_THREADS": "1"}

    def run(*extra, ckpt):
        return subprocess.run(
            [sys.executable, "-m",
             "pytorch_distributed_training_tpu_torch.cli.main", *argv,
             "--checkpoint-dir", str(ckpt), *extra],
            cwd=REPO, env=env, capture_output=True, text=True, timeout=180)

    ref = run(ckpt=tmp_path / "ref")
    assert ref.returncode == 0, ref.stderr[-2000:]
    res = run("--elastic", "--max-restarts", "1", "--inject-faults",
              "crash@3", ckpt=tmp_path / "ck")
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-2000:]
    assert "supervisor: training exited with 13; restart 1/1" in res.stdout
    assert ("supervisor: finished after 1 restarts (0 hang kills, 0 "
            "preemptions), exit 0") in res.stdout
    assert res.stdout.count("training started") == 2
    assert "training finished" in res.stdout
    manifests = [CheckpointManager(str(d)).manifest(8)["leaves"]
                 for d in (tmp_path / "ref", tmp_path / "ck")]
    assert manifests[0] == manifests[1]
