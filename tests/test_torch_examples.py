"""The README's entry points on the port print what the reference's print:

* ``examples/smr_demo_torch.py`` and ``examples/quickstart_torch.py``
  against ``smr_demo.py`` and ``quickstart.py``: the whole output, line
  for line (the port's simulator is bit-exact with the reference's);
* ``examples/serve_paged_torch.py --device cpu`` against
  ``serve_paged.py`` under three flag sets: the per-request token lines
  and the ``use-after-free`` / ``no leaks`` lines.  Both scripts serve the
  same weights: the test bridges the reference's ``init_params(cfg,
  PRNGKey(0))`` and puts it in place of the twin module's
  ``init_params``, so the script itself gains nothing for the test.

Each reference script runs in a subprocess; the serving twin runs
in-process (its ``main(argv)``), the simulator twins in subprocesses.
"""

import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import jax
import pytest

from repro.configs.base import ArchConfig as JArch
from repro.configs.base import dense_stack as j_stack
from repro.models.model import init_params as j_init
from repro_torch.bridge import params_from_jax
from repro_torch.configs.base import ArchConfig, dense_stack

ROOT = Path(__file__).resolve().parents[1]
ENV = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
# examples/serve_paged.py's config
SERVE_DEMO = dict(name="serve-demo", d_model=64, n_heads=4, n_kv_heads=2,
                  d_ff=128, vocab=128, remat="none", dtype="float32")


SERVE_FLAGS = {
    "paged-prefix-cache": ["--kv-store", "paged", "--prefix-cache"],
    "engines2-prefill2-chunk4": ["--engines", "2", "--prefill-workers", "2",
                                 "--prefill-chunk", "4"],
    "hazardptrpop-vec": ["--smr", "HazardPtrPOP", "--sim-backend", "vec"],
}


@pytest.fixture(scope="module")
def scripts():
    """Every script run this file compares, started together (the
    reference's paged serving runs its Pallas kernel in interpret mode:
    the longest); ``scripts(key)`` waits for one and returns its
    output."""
    runs = {f"{n}{t}": [f"{n}{t}.py"] for n in ("smr_demo", "quickstart")
            for t in ("", "_torch")}
    runs.update((k, ["serve_paged.py"] + f) for k, f in SERVE_FLAGS.items())
    procs = {k: subprocess.Popen(
        [sys.executable, str(ROOT / "examples" / a[0]), *a[1:]], cwd=ROOT,
        env=ENV, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for k, a in runs.items()}

    def wait(key):
        out, err = procs[key].communicate(timeout=300)
        assert procs[key].returncode == 0, out + err
        return out
    yield wait
    for p in procs.values():
        if p.poll() is None:
            p.kill()
        p.communicate()


@pytest.mark.parametrize("name", ["smr_demo", "quickstart"])
def test_simulator_twin_prints_the_reference_lines(name, scripts):
    want = scripts(name).splitlines()
    got = scripts(f"{name}_torch").splitlines()
    assert len(got) > 5
    assert got == want


def _load_twin():
    spec = importlib.util.spec_from_file_location(
        "serve_paged_torch", ROOT / "examples" / "serve_paged_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _compared(text):
    """The lines both scripts must print alike: each request's tokens,
    the use-after-free line and the leak check."""
    lines = [ln for ln in text.splitlines()
             if ln.startswith(("req ", "use-after-free:", "no leaks:"))]
    assert lines[-2:] == ["use-after-free: none (hard error if one had "
                          "occurred)", "no leaks: True"], text
    return lines


@pytest.mark.parametrize("key", list(SERVE_FLAGS))
def test_serve_paged_twin_prints_the_reference_tokens(key, scripts,
                                                      monkeypatch, capsys):
    weights = jax.device_get(j_init(JArch(groups=j_stack(2), **SERVE_DEMO),
                                    jax.random.PRNGKey(0)))

    def reference_weights(cfg, generator, device=None):
        assert cfg == ArchConfig(groups=dense_stack(2), **SERVE_DEMO)
        return params_from_jax(weights, device)

    mod = _load_twin()
    monkeypatch.setattr(mod, "init_params", reference_weights)
    mod.main(SERVE_FLAGS[key] + ["--device", "cpu"])
    got = _compared(capsys.readouterr().out)
    assert len(got) == 12                 # 10 requests + the two checks
    assert got == _compared(scripts(key))


def test_serve_paged_twin_has_every_reference_flag():
    """The twin's options are the reference's plus ``--device``, with the
    same defaults."""
    import argparse

    def options(path):
        seen = {}
        real = argparse.ArgumentParser.parse_args

        def grab(self, args=None, namespace=None):
            seen.update((a.dest, a.default) for a in self._actions
                        if a.dest != "help")
            raise SystemExit(0)
        argparse.ArgumentParser.parse_args = grab
        try:
            spec = importlib.util.spec_from_file_location("m", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            with pytest.raises(SystemExit):
                mod.main()
        finally:
            argparse.ArgumentParser.parse_args = real
        return seen

    want = options(ROOT / "examples" / "serve_paged.py")
    got = options(ROOT / "examples" / "serve_paged_torch.py")
    assert {"smr", "engines", "kv_store", "migrate", "trace"} <= set(want)
    assert got == dict(want, device="cuda")
