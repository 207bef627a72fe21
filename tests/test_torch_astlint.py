"""analysis/astlint: the JAX tests' fixture sources (tests/test_analysis.py)
run through both linters find the same rule at the same line, except
where the port's rule differs by design (listed in DESIGNED below); the
port's own seeds of host-sync-in-hot-loop; the vocabulary read by parsing
obs/telemetry.py, never importing it; the committed port tree lints clean
against the port's baseline."""

import os
import subprocess
import sys

import pytest

from stencil_tpu.analysis import astlint as jlint
from stencil_tpu_torch.analysis import astlint as tlint
from stencil_tpu_torch.apps import lint_tool
from stencil_tpu_torch.obs import telemetry

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (fixture id, repo-relative path, source, rules or None): the sources of
# tests/test_analysis.py's lint tests
FIXTURES = [
    ("stdlib-nested", "obs/ledger.py",
     "import json\nfrom numpy import array as arr\ndef append(path):\n"
     "    import jax\n    return jax, arr\n", None),
    ("stdlib-relative", "obs/status.py", "from .telemetry import Recorder\n", None),
    ("stdlib-clean", "obs/watchdog.py",
     "import json\nimport os\ntry:\n    import fcntl\nexcept ImportError:\n    fcntl = None\n",
     None),
    ("stdlib-bench-top", "bench.py", "import jax\n", None),
    ("stdlib-bench-child", "bench.py",
     "import json\ndef child():\n    import jax\n    return jax\n", None),
    ("stdlib-elsewhere", "lib/other.py", "import jax\n", None),
    ("vocab-typo", "lib/site.py", "def emit(rec):\n    rec.counter('recover.rollbck', value=1)\n",
     None),
    ("vocab-good", "lib/site.py",
     "def emit(rec, kind):\n    rec.gauge('exchange.trimean_s', 1.0)\n"
     "    rec.counter(f'census.{kind}', value=1)\n"
     "    rec.emit('gauge', 'jacobi.mcells_per_s', value=1.0)\n", None),
    ("vocab-fields", "lib/site.py",
     "def emit(rec):\n    rec.meta('analysis.plan_verdict', method='x', ok=1)\n"
     "    rec.meta('recover.aborted', reason='r', step=1)\n", None),
    ("atomic-plain", "lib/w.py",
     "import json\ndef save(path, doc):\n    with open(path, 'w') as f:\n"
     "        json.dump(doc, f)\n", None),
    ("atomic-str-replace", "lib/w.py",
     "import json\ndef save(path, doc):\n    key = path.replace('-', '_')\n"
     "    with open(path, 'w') as f:\n        json.dump({key: doc}, f)\n", None),
    ("atomic-protocol", "lib/w.py",
     "import json, os\ndef save(path, doc):\n    tmp = path + '.tmp'\n"
     "    with open(tmp, 'w') as f:\n        json.dump(doc, f)\n        os.fsync(f.fileno())\n"
     "    os.replace(tmp, path)\n", None),
    ("assert-boundaries", "lib/api.py",
     "class Dom:\n    def realize(self, n):\n        assert n >= 1\n"
     "    def _inner(self, n):\n        assert n >= 1\n"
     "def make_loop(k):\n    assert k > 0\n    def body(x):\n        assert x is not None\n"
     "    return body\ndef assert_consistent(a):\n    assert a\n", ["no-bare-assert"]),
    ("assert-conditional", "lib/api.py",
     "import sys\nif sys.platform == 'linux':\n    def realize(n):\n        assert n >= 1\n",
     ["no-bare-assert"]),
    ("assert-tests", "tests/test_x.py", "def run(n):\n    assert n\n", ["no-bare-assert"]),
    ("assert-scripts", "scripts/probe.py", "def run(n):\n    assert n\n", ["no-bare-assert"]),
    ("placeholder-bad", "lib/e.py",
     "def fail(name, log):\n    log.warn('method {name} is slow')\n"
     "    raise ValueError('unknown method {name!r}')\n", None),
    ("placeholder-good", "lib/e.py",
     "def fail(name):\n    raise ValueError(f'unknown method {name}')\n"
     "def fail2(name):\n    raise ValueError('unknown method {}'.format(name))\n"
     "def fail3():\n    raise ValueError('literal braces {{x}} are fine')\n"
     "def fail4(name):\n    raise ValueError('config shape: {\"a\": 1} etc')\n", None),
    ("hostsync-jit-time", "lib/hot.py",
     "import time\nimport jax\ndef make_step():\n    def body(x):\n        t = time.time()\n"
     "        return x + t\n    return jax.jit(body)\n", None),
    ("hostsync-propagates", "lib/hot.py",
     "import jax\ndef helper(x):\n    return float(x.item())\ndef make_step():\n"
     "    def body(x):\n        return helper(x)\n    return jax.jit(body)\n",
     ["host-sync-in-hot-loop"]),
    ("hostsync-host-code", "lib/host.py",
     "import time\ndef time_loop(fn, state):\n    t0 = time.perf_counter()\n"
     "    state = fn(state)\n    return state, time.perf_counter() - t0\n",
     ["host-sync-in-hot-loop"]),
    ("pragma-honored", "lib/api.py",
     "def realize(n):\n    assert n >= 1  # lint: disable=no-bare-assert\n"
     "    # lint: disable=no-bare-assert (documented: perf-critical)\n    assert n < 100\n",
     ["no-bare-assert"]),
    ("pragma-typo", "lib/api.py",
     "def realize(n):\n    assert n >= 1  # lint: disable=no-bear-assert\n", None),
]

# Where the port's rule differs by design, and what the port finds instead.
DESIGNED = {
    # the port has no bench.py parent: no file is held to the stdlib at its
    # top level alone
    "stdlib-bench-top": set(),
    # host-sync seeds on the JAX trace wrappers (jax.jit) in the JAX rule;
    # the port's eager loops have none, so it seeds on its loop builders and
    # kernel wrappers by file and name, and lib/hot.py is neither
    "hostsync-jit-time": set(),
    "hostsync-propagates": set(),
}


def _lint(mod, tmp_path, relpath, src, rules):
    f = tmp_path / relpath
    f.parent.mkdir(parents=True, exist_ok=True)
    f.write_text(src)
    findings, errors = mod.lint_paths([str(f)], repo_root=str(tmp_path), rules=rules)
    assert not errors, errors
    return {(x.rule, x.line) for x in findings}


@pytest.mark.parametrize("fid,relpath,src,rules", FIXTURES, ids=[f[0] for f in FIXTURES])
def test_fixtures_find_what_jax_finds(tmp_path, fid, relpath, src, rules):
    j = _lint(jlint, tmp_path / "j", relpath, src, rules)
    t = _lint(tlint, tmp_path / "t", relpath, src, rules)
    if fid in DESIGNED:
        assert j and t == DESIGNED[fid]
    else:
        assert t == j


def test_rules_and_engine_match_jax():
    assert sorted(tlint.RULES) == sorted(jlint.RULES)
    assert tlint.SEVERITIES == jlint.SEVERITIES
    with pytest.raises(ValueError, match="unknown rule"):
        tlint.lint_paths(["stencil_tpu_torch"], repo_root=REPO, rules=["no-such-rule"])


def test_fingerprints_and_baseline_match_jax(tmp_path):
    src = "def realize(n):\n    assert n >= 1\n"
    for mod, d in ((jlint, "j"), (tlint, "t")):
        f = tmp_path / d / "lib" / "api.py"
        f.parent.mkdir(parents=True)
        f.write_text(src)
        found, _ = mod.lint_paths([str(f)], repo_root=str(tmp_path / d),
                                  rules=["no-bare-assert"])
        mod.write_baseline(str(tmp_path / d / "b.json"), found)
    jf, _ = jlint.lint_paths([str(tmp_path / "j" / "lib")], repo_root=str(tmp_path / "j"))
    tf, _ = tlint.lint_paths([str(tmp_path / "t" / "lib")], repo_root=str(tmp_path / "t"))
    assert [x.fingerprint for x in tf] == [x.fingerprint for x in jf]
    assert (tmp_path / "t" / "b.json").read_text() == (tmp_path / "j" / "b.json").read_text()
    (tmp_path / "bad.json").write_text('{"not": "a baseline"}')
    with pytest.raises(ValueError, match="v1 lint baseline"):
        tlint.load_baseline(str(tmp_path / "bad.json"))


HOT = {
    # a loop builder: its returned closures are hot, its own body is not
    "ops/jacobi.py": (
        "import time\n"
        "def make_jacobi_loop(ex, iters):\n"
        "    k = int(ex.plan[0])\n"                      # build time: not flagged
        "    def loop(curr, nxt, sel):\n"
        "        v = curr.sum().item()\n"                # flagged
        "        t = time.time()\n"                      # flagged
        "        return _step(curr), nxt\n"
        "    return loop\n"
        "def _step(t):\n"
        "    return float(t[0, 0])\n"                    # reached: flagged
        "def elsewhere(t):\n"
        "    return t.cpu()\n",                          # not reached
        {5, 6, 10}),
    # a kernel wrapper: its body is hot, its plain version is not
    "ops/halo_fill.py": (
        "import numpy as np\nimport torch\n"
        "def self_fill(blocks, spec, axis):\n"
        "    if blocks[0].device.type == 'cpu':\n"
        "        return self_fill_plain(blocks, spec, axis)\n"
        "    n = int(blocks[0].shape[0])\n"             # a size: not flagged
        "    torch.cuda.synchronize()\n"                # flagged
        "    return np.asarray(blocks[0].tolist())\n"   # flagged twice
        "def self_fill_plain(blocks, spec, axis):\n"
        "    return [b.cpu() for b in blocks]\n",        # the plain version: exempt
        {7, 8}),
}


@pytest.mark.parametrize("relpath", sorted(HOT))
def test_host_sync_seeds_on_loop_builders_and_wrappers(tmp_path, relpath):
    src, lines = HOT[relpath]
    got = _lint(tlint, tmp_path, "stencil_tpu_torch/" + relpath, src,
                ["host-sync-in-hot-loop"])
    assert {line for _rule, line in got} == lines
    # the same source under a file that holds no seed is not hot
    assert _lint(tlint, tmp_path, "lib/cold.py", src, ["host-sync-in-hot-loop"]) == set()


def test_vocab_is_parsed_not_imported(tmp_path):
    assert tlint.parse_vocab(os.path.join(REPO, tlint.TELEMETRY_FILE)) == telemetry.KNOWN_NAMES
    code = ("import sys\n"
            f"sys.path.insert(0, {REPO!r})\n"
            "import importlib.util\n"
            f"spec = importlib.util.spec_from_file_location('al', "
            f"{os.path.join(REPO, 'stencil_tpu_torch', 'analysis', 'astlint.py')!r})\n"
            "al = importlib.util.module_from_spec(spec)\n"
            "sys.modules['al'] = al\n"
            "spec.loader.exec_module(al)\n"
            f"found, errs = al.lint_paths([{os.path.join(REPO, 'stencil_tpu_torch', 'obs')!r}],"
            f" repo_root={REPO!r})\n"
            "assert not errs, errs\n"
            "print(len(al.telemetry_vocab({!r})), 'torch' in sys.modules)\n".format(REPO))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=120)
    assert p.returncode == 0, p.stderr
    n, torch_loaded = p.stdout.split()
    assert int(n) == len(telemetry.KNOWN_NAMES) and torch_loaded == "False"
    bad = tmp_path / "telemetry.py"
    bad.write_text("X = 1\n")
    with pytest.raises(ValueError, match="no NAME_FIELDS"):
        tlint.parse_vocab(str(bad))


def test_pure_stdlib_holds_the_ports_file_path_modules():
    paths = [os.path.join(REPO, "stencil_tpu_torch", "obs", f)
             for f in ("watchdog.py", "ledger.py", "status.py")]
    found, errors = tlint.lint_paths(paths, repo_root=REPO, rules=["pure-stdlib"])
    assert (found, errors) == ([], [])
    assert all(tlint._pure_stdlib_applies(os.path.relpath(p, REPO)) for p in paths)


def test_committed_port_tree_lints_clean_against_its_baseline(capsys):
    assert lint_tool.main(["lint", "--root", REPO]) == 0
    out = capsys.readouterr().out
    assert "0 new finding(s)" in out
    assert lint_tool.main(["lint", "--root", REPO, "--list-rules"]) == 0
    assert "host-sync-in-hot-loop" in capsys.readouterr().out
