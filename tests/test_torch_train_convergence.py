"""train_convergence --smoke on the CPU: the orchestration of a short
pretraining run (a worker held after its update two past the first
restore bundle, a SIGTERM, the trainer's bundle at that step, a second
worker that resumes there, from the very state saved, and runs to the
end), deterministic in its steps: the SIGTERM always lands at the held
update."""

import json
import math

import pytest

from clipbert_tpu_torch import train_convergence

STEPS = 8


def test_smoke_run_resumes_at_the_sigterm(capsys):
    hold = train_convergence.first_bundle_step(STEPS) + 2
    try:
        out = train_convergence.main(["--smoke", "--steps", str(STEPS),
                                      "--img", "64", "--threads", "2"])
        code = 0
    except SystemExit as e:
        code = e.code
        out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["metric"] == "cpu_smoke_convergence_run"
    assert out["sigterm_at_step"] == out["resumed_step"] == hold == 4
    assert out["global_step"] == STEPS and out["resumed_at_sigterm"]
    assert len(out["step_losses_a"]) == hold
    assert len(out["step_losses_b"]) == STEPS - hold
    losses = out["step_losses_a"] + out["step_losses_b"]
    assert all(math.isfinite(x) and x > out["itm_floor"] for x in losses)
    assert out["restored_state_matches"] and out["resume_continues"]
    verdicts = ("resumed_at_sigterm", "descends", "resume_continues")
    assert code == (0 if all(out[k] for k in verdicts) else 1)


def test_too_few_steps_for_a_sigterm():
    with pytest.raises(ValueError, match="too short"):
        train_convergence.main(["--smoke", "--steps", "3"])
