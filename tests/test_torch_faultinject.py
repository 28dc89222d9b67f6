"""Kill and resume the port's LM trainer bit for bit (oracle
``tests/test_faultinject.py``).

The trainer (``apex_tpu_torch.examples.lm.main_amp``) runs as a
subprocess on the CPU at a tiny size, K 2, a checkpoint every 2 steps,
to step 12.  It is drained with SIGTERM (the trainer finishes the
window, writes a final checkpoint and exits 0) or killed with SIGKILL
mid-run, at a step drawn from a seeded RNG and after its first
checkpoint is published; ``--resume`` then runs it to the end, and its
final checkpoint equals the uninterrupted run's in every leaf, bit for
bit (the masters, both Adam moments and its step, the scaler).

Run as a script, this file is the child: the trainer's ``main`` with a
short sleep after each window, so a signal lands mid-run.
"""

import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

STEPS = 12
SPC = 2
SAVE_EVERY = 2
_KILL_RNG = np.random.RandomState(20261017)
REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
TINY = ["--synthetic", "--device", "cpu", "--vocab", "64", "--hidden", "32",
        "--layers", "2", "--heads", "4", "--seq-len", "17", "-b", "2",
        "--opt-level", "O2", "--loss-scale", "dynamic"]


def _argv(ck, resume=False):
    return ([sys.executable, "-u", os.path.abspath(__file__)] + TINY
            + ["--steps", str(STEPS), "--steps-per-call", str(SPC),
               "--checkpoint-dir", ck, "--checkpoint-every",
               str(SAVE_EVERY)] + (["--resume"] if resume else []))


def _spawn(argv):
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    return subprocess.Popen(argv, cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _run(argv, timeout=240):
    proc = _spawn(argv)
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, _ = proc.communicate()
        raise AssertionError(f"trainer timed out:\n{out}")
    return proc.returncode, out


def _run_and_kill(sig, kill_at, ck, timeout=240):
    """Run the trainer; once a ``step N`` line reaches ``kill_at`` and a
    checkpoint is published, send ``sig``.  Returns ``(rc, output)``."""
    from apex_tpu_torch.checkpoint import latest_checkpoint

    proc = _spawn(_argv(ck))
    lines, sent, t0 = [], False, time.time()
    try:
        for line in proc.stdout:
            lines.append(line)
            if time.time() - t0 > timeout:
                raise AssertionError("trainer outran the kill:\n"
                                     + "".join(lines))
            if not sent and line.startswith("step "):
                if int(line.split()[1]) >= kill_at:
                    while latest_checkpoint(ck) is None:
                        time.sleep(0.01)
                    proc.send_signal(sig)
                    sent = True
                    if sig == signal.SIGKILL:
                        break
        proc.wait(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert sent, f"trainer finished before step {kill_at}:\n" + "".join(lines)
    return proc.returncode, "".join(lines)


def _final(ck):
    step_dir = os.path.join(ck, f"step_{STEPS:08d}")
    assert os.path.isdir(step_dir), f"no final checkpoint under {ck}"
    out = {}
    for name in os.listdir(step_dir):
        if name.endswith(".npz"):
            with np.load(os.path.join(step_dir, name)) as z:
                out.update({k: z[k] for k in z.files})
    return out


@pytest.fixture(scope="module")
def uninterrupted(tmp_path_factory):
    ck = str(tmp_path_factory.mktemp("uninterrupted") / "ck")
    rc, log = _run(_argv(ck))
    assert rc == 0 and f"checkpoint: step {STEPS} saved" in log, log
    return _final(ck)


def _assert_parity(oracle, ck, log):
    got = _final(ck)
    assert sorted(got) == sorted(oracle)
    assert any(k.startswith("opt_state/exp_avg_sq/") for k in got)
    assert "scaler/loss_scale" in got and "opt_state/step" in got
    for k in oracle:
        assert got[k].dtype == oracle[k].dtype
        np.testing.assert_array_equal(
            got[k], oracle[k], err_msg=f"leaf {k!r} after resume\n{log}")


def test_sigterm_drain_then_resume_is_bit_identical(tmp_path,
                                                    uninterrupted):
    ck = str(tmp_path / "ck")
    kill_at = SPC * int(_KILL_RNG.randint(1, STEPS // SPC - 1))
    rc, log = _run_and_kill(signal.SIGTERM, kill_at, ck)
    assert rc == 0, f"the drain should exit cleanly:\n{log}"
    assert "drain: stopping at step" in log, log
    rc2, log2 = _run(_argv(ck, resume=True))
    assert rc2 == 0 and "resumed at step" in log2, log2
    assert f"checkpoint: step {STEPS} saved" in log2, log2
    _assert_parity(uninterrupted, ck, log + log2)


def test_sigkill_midrun_then_resume_is_bit_identical(tmp_path,
                                                     uninterrupted):
    ck = str(tmp_path / "ck")
    kill_at = SPC * int(_KILL_RNG.randint(2, STEPS // SPC - 1))
    rc, log = _run_and_kill(signal.SIGKILL, kill_at, ck)
    assert rc == -signal.SIGKILL, f"SIGKILL must not exit cleanly:\n{log}"
    rc2, log2 = _run(_argv(ck, resume=True))
    assert rc2 == 0 and "resumed at step" in log2, log2
    _assert_parity(uninterrupted, ck, log + log2)


def test_resume_of_a_finished_run_changes_nothing(tmp_path, uninterrupted):
    """``--resume`` at the last step runs no step and keeps the final
    checkpoint as it was."""
    ck = str(tmp_path / "ck")
    assert _run(_argv(ck))[0] == 0
    rc, log = _run(_argv(ck, resume=True))
    assert rc == 0 and f"resumed at step {STEPS}" in log, log
    _assert_parity(uninterrupted, ck, log)


def _child(argv):
    """The trainer with a 100 ms sleep after every window."""
    from apex_tpu_torch import runtime
    from apex_tpu_torch.examples.lm import main_amp

    step_window = runtime.StepPipeline.step_window

    def slow(self, *args, **kw):
        out = step_window(self, *args, **kw)
        time.sleep(0.1)
        return out
    runtime.StepPipeline.step_window = slow
    return main_amp.main(argv)


if __name__ == "__main__":
    sys.exit(_child(sys.argv[1:]))
