"""The port's fault-injection registry against the JAX package's, on the
CPU: the serving tests of ``tests/test_faults.py``, each with a
counterpart here, and the serve fault smoke in process and through its
``--serve-smoke`` command line.  ``repro_torch.testing.faults`` imports
neither JAX nor the JAX package."""
import dataclasses
import os
import subprocess
import sys

import pytest

from repro.testing import faults as jfaults
from repro_torch.testing import faults

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _rules(plan):
    """A plan's rules as comparable tuples, without the reference-only
    worker index."""
    return [tuple(getattr(r, f.name) for f in dataclasses.fields(
        faults.Fault)) for r in plan.rules]


SPECS = ["raise@probe.time:2x3; delay@probe.prepare:1~0.5;exit@tables.bucket",
         "nan@serve.nan:rid=1,t=2;delay@serve.chunk:3~0.1",
         "raise@serve.worker:3;delay@serve.arrival:2~0.02",
         "nan@serve.nan:rid=0,at=4;kill@serve.admit:1x2"]


@pytest.mark.parametrize("spec", SPECS)
def test_parse_env_spec_matches_the_reference(spec):
    assert _rules(faults.parse_env_spec(spec)) == \
        _rules(jfaults.parse_env_spec(spec))


def test_parse_env_spec():
    plan = faults.parse_env_spec(SPECS[0])
    a, b, c = plan.rules
    assert (a.point, a.action, a.nth, a.times) == ("probe.time", "raise", 2, 3)
    assert (b.action, b.seconds) == ("delay", 0.5)
    assert (c.point, c.nth, c.times) == ("tables.bucket", 1, 1)
    with pytest.raises(ValueError):
        faults.parse_env_spec("frobnicate@x")
    with pytest.raises(ValueError):
        faults.parse_env_spec("raise@")


def test_actions_are_the_references_but_the_worker_ones():
    """The worker actions came with the distributed build: the port's
    actions, process actions included, are now the reference's."""
    assert faults.ACTIONS == jfaults.ACTIONS
    assert faults.PROCESS_ACTIONS == jfaults.PROCESS_ACTIONS
    assert faults.ENV_VAR == jfaults.ENV_VAR == "REPRO_FAULTS"
    assert faults.Fault("dist.item", "kill-worker", widx=0).widx == 0
    with pytest.raises(ValueError, match="unknown action"):
        faults.Fault("dist.item", "frobnicate")


def test_parse_env_spec_serve_nan_kv_form():
    plan = faults.parse_env_spec(SPECS[1])
    a, b = plan.rules
    assert (a.point, a.action, a.rid, a.at) == ("serve.nan", "nan", 1, 2)
    assert (b.point, b.action, b.nth, b.seconds) == ("serve.chunk", "delay",
                                                     3, 0.1)
    with faults.inject(*plan.rules):
        assert faults.serve_nan_spec() == {1: 2}
    assert faults.serve_nan_spec() == {}       # no active plan
    with faults.inject(faults.Fault("serve.nan", "nan", rid=0, at=4),
                       faults.Fault("serve.nan", "nan", rid=3, at=0)):
        assert faults.serve_nan_spec() == {0: 4, 3: 0}


def test_env_reload_picks_up_mutation(monkeypatch):
    monkeypatch.delenv(faults.ENV_VAR, raising=False)
    faults.env_reload()
    assert faults.active() is None
    monkeypatch.setenv(faults.ENV_VAR, "nan@serve.nan:rid=2,t=1")
    assert faults.active() is None             # stale cache by design
    plan = faults.env_reload()
    assert plan is not None and faults.serve_nan_spec() == {2: 1}
    monkeypatch.delenv(faults.ENV_VAR)
    assert faults.env_reload() is None


def test_tick_clock_is_deterministic():
    clk = faults.TickClock(dt=0.5, t0=2.0)
    jclk = jfaults.TickClock(dt=0.5, t0=2.0)
    assert [clk() for _ in range(3)] == [jclk() for _ in range(3)] == \
        [2.0, 2.5, 3.0]


def test_counted_rules_fire_on_exact_hits():
    with faults.inject(faults.Fault("pt", "raise", nth=2, times=2)) as plan:
        faults.hit("pt")                       # hit 1: unarmed
        with pytest.raises(faults.FaultError):
            faults.hit("pt")                   # hit 2: fires
        with pytest.raises(faults.FaultError):
            faults.hit("pt")                   # hit 3: fires
        faults.hit("pt")                       # hit 4: past the window
        assert [n for (_, n, _) in plan.fired] == [2, 3]
    faults.hit("pt")                           # no active plan: no-op


def test_kill_is_not_swallowed_by_except_exception():
    with faults.inject(faults.Fault("pt", "kill")):
        with pytest.raises(faults.FaultKill):
            try:
                faults.hit("pt")
            except Exception:                  # noqa: BLE001
                pytest.fail("FaultKill was caught as an Exception")


def test_delay_rule_sleeps_and_is_recorded():
    with faults.inject(faults.Fault("serve.chunk", "delay", nth=2,
                                    seconds=0.01)) as plan:
        for _ in range(3):
            faults.hit("serve.chunk")
    assert plan.fired == [("serve.chunk", 2, "delay")]


def test_mangle_tears_and_garbles_as_the_reference_does():
    data = b"0123456789abcdef\n"
    for mod in (faults, jfaults):
        with mod.inject(mod.Fault("w", "torn", keep_bytes=5)):
            assert mod.mangle("w", data) == data[:5]
            with pytest.raises(mod.FaultKill):
                mod.hit("w.done")
        with mod.inject(mod.Fault("w", "garble", nth=2)):
            assert mod.mangle("w", data) == data
            assert mod.mangle("w", data) == mod.GARBLED_LINE
    assert faults.GARBLED_LINE == jfaults.GARBLED_LINE
    assert faults.mangle("w", data) == data    # no active plan


def test_nan_logits_hook_poisons_one_slot_at_one_step():
    import jax.numpy as jnp
    import numpy as np
    import torch
    logits = torch.arange(24, dtype=torch.float32).reshape(3, 1, 8)
    hook = faults.nan_logits_hook(1, 4)
    assert torch.equal(hook(logits, torch.tensor(3)), logits)
    out = hook(logits, torch.tensor(4))
    assert bool(torch.isnan(out[1]).all())
    assert torch.equal(out[[0, 2]], logits[[0, 2]])
    jout = np.asarray(jfaults.nan_logits_hook(1, 4)(
        jnp.asarray(logits.numpy()), 4))
    np.testing.assert_array_equal(out.numpy(), jout)


def test_serve_fault_smoke_inprocess():
    out = faults.serve_fault_smoke(device="cpu")
    assert out["survivors_bit_identical"]
    assert out["aborted"] == {1: 2}
    assert len(out["delay_rules_fired"]) >= 2
    assert out["device"] == "cpu"


def test_faults_cli_serve_smoke_flag():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS=os.environ.get("JAX_PLATFORMS", "cpu"))
    env.pop(faults.ENV_VAR, None)
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.testing.faults", "--serve-smoke",
         "--device", "cpu"], env=env, capture_output=True, text=True,
        timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "SERVE_FAULT_SMOKE_OK" in r.stdout, r.stdout + r.stderr


def test_faults_module_imports_neither_jax_nor_repro():
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['repro'] = None\n"
            "import repro_torch.testing.faults as f\n"
            "import repro_torch.runtime.serving\n"
            "assert f.parse_env_spec('raise@serve.worker:3').rules\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'repro') and sys.modules[m] is not None]\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr
