"""analysis/jit_audit on the CPU: the clean guarded chunk loop passes on one
block and over 8 positions; first-use work after warm-up (a loop built for
a cold chunk size, a ``_native.kept`` miss) fails it; the host-sync check,
which needs the card's sync debug mode, is listed as not made with its
reason and never as passed; an unknown inject raises. Its verdict and
record keep the JAX module's fields."""

import json

import pytest
import torch

from stencil_tpu.analysis import jit_audit as jja
from stencil_tpu_torch.analysis import jit_audit as ja
from stencil_tpu_torch.obs import telemetry
from stencil_tpu_torch.ops import _native
from stencil_tpu_torch.ops import jacobi as tjacobi

torch.set_num_threads(2)


@pytest.mark.parametrize("devices", [["cpu"], ["cpu"] * 8], ids=["one-block", "8-positions"])
def test_clean_loop_passes(devices):
    r = ja.run_audit(size=16, iters=10, chunk=4, devices=devices)
    assert r.ok and r.recompiles == 0 and r.transfer_trips == []
    assert (r.steps, r.chunks) == (10, 3)
    assert r.first_use == {"build": 0, "table": 0, "graph": 0, "loop": 0}
    assert r.warmup_compiles == 2  # the loops of sizes 4 and 2


def test_host_sync_check_is_not_made_on_the_cpu():
    for inject in (None, "host-sync"):
        r = ja.run_audit(size=16, iters=10, chunk=4, inject=inject, devices=["cpu"])
        assert [m["check"] for m in r.not_made] == ["host-sync"]
        assert "CUDA device" in r.not_made[0]["reason"]
        assert r.to_json()["not_made"] == r.not_made
        assert r.transfer_trips == []  # nothing claimed caught or passed


def test_cold_tail_chunk_fails():
    r = ja.run_audit(size=16, iters=10, chunk=4, inject="recompile", devices=["cpu"] * 8)
    assert not r.ok and r.recompiles == 1 and r.first_use["loop"] == 1
    with pytest.raises(ValueError, match="distinct sizes"):
        ja.run_audit(size=16, iters=8, chunk=4, inject="recompile", devices=["cpu"])


def test_kept_miss_after_warmup_fails(monkeypatch):
    """A loop that uploads a new table on every call (a ``_native.kept``
    miss each time) fails the audit even when every size was warmed."""
    made = tjacobi.make_jacobi_loop
    calls = [0]

    def leaky(ex, iters, **kw):
        inner = made(ex, iters, **kw)

        def loop(curr, nxt, sel):
            calls[0] += 1
            _native.kept(("jit-audit-test", calls[0]), lambda: [0])
            return inner(curr, nxt, sel)

        return loop

    monkeypatch.setattr(tjacobi, "make_jacobi_loop", leaky)
    r = ja.run_audit(size=16, iters=10, chunk=4, devices=["cpu"])
    assert not r.ok and r.first_use["table"] == 3 and r.recompiles == 3


def _ptrs(state):
    return tuple(b.data_ptr() for b in state) if isinstance(state, list) else state.data_ptr()


def _address_keyed(monkeypatch, module):
    """``module.make_jacobi_loop`` wrapped so each loop call keeps a table
    by its buffers' addresses, as the kernels do on the card; returns the
    calls' misses, in order."""
    made = tjacobi.make_jacobi_loop
    misses = []

    def keyed(ex, iters, **kw):
        inner = made(ex, iters, **kw)

        def loop(curr, nxt, sel):
            key = ("jit-audit-test", iters, _ptrs(curr), _ptrs(nxt))
            misses.append(key not in _native._tables)
            _native.kept(key, lambda: [0])
            return inner(curr, nxt, sel)

        loop.temporal_k = getattr(inner, "temporal_k", 0)
        return loop

    monkeypatch.setattr(module, "make_jacobi_loop", keyed)
    return misses


@pytest.mark.parametrize("devices", [["cpu"], ["cpu"] * 8], ids=["one-block", "8-positions"])
def test_tables_kept_by_address_are_warm(monkeypatch, devices):
    """A chunk may start from either buffer order (one block's multistep
    pass swaps them): the warm-up covers both, so tables keyed by address
    all hit in the audited chunks."""
    misses = _address_keyed(monkeypatch, tjacobi)
    r = ja.run_audit(size=16, iters=10, chunk=4, devices=devices)
    assert r.ok and r.first_use["table"] == 0, r.to_json()
    assert misses[-3:] == [False] * 3 and sum(misses) == 4  # 2 sizes x 2 orders


@pytest.mark.parametrize("ckpt", [False, True], ids=["advancing", "checkpointed"])
@pytest.mark.parametrize("devices", [None, ["cpu"] * 8], ids=["one-block", "8-positions"])
def test_jacobi3d_warmup_leaves_no_table_upload(tmp_path, monkeypatch, ckpt, devices):
    """jacobi3d warms as the audit does: no timed chunk of a 10-step run in
    chunks of 4 ([4, 4, 2]) misses a table kept by its buffers' addresses,
    with or without a checkpoint dir (whose warm-up never advances)."""
    from stencil_tpu_torch.apps import jacobi3d

    misses = _address_keyed(monkeypatch, jacobi3d)
    kw = dict(device="cpu") if devices is None else dict(
        devices=devices, method=jacobi3d.Method.REMOTE_DMA)
    jacobi3d.run(16, 16, 16, iters=10, chunk=4, weak=False,
                 ckpt_dir=str(tmp_path / "ck") if ckpt else None, **kw)
    assert len(misses) == 4 + (not ckpt) + 3 and misses[-3:] == [False] * 3, misses


def test_unknown_inject_raises():
    with pytest.raises(ValueError, match="unknown inject mode 'sync'"):
        ja.run_audit(inject="sync", devices=["cpu"])
    assert ja.INJECT_MODES == jja.INJECT_MODES


def test_result_and_record_keep_the_jax_fields(tmp_path):
    jkeys = set(jja.AuditResult(ok=True, recompiles=0).to_json())
    rec = telemetry.Recorder(sink=str(tmp_path / "m.jsonl"))
    r = ja.run_audit(size=16, iters=6, chunk=4, devices=["cpu"], rec=rec)
    rec.close()
    assert jkeys <= set(r.to_json())
    lines = open(tmp_path / "m.jsonl").read().splitlines()
    assert telemetry.validate_jsonl(lines) == (len(lines), [])
    recs = {json.loads(ln)["name"]: json.loads(ln) for ln in lines}
    assert set(recs) == {"analysis.jit_warmup", "analysis.jit_audit_loop", "analysis.jit_audit"}
    assert recs["analysis.jit_audit"]["not_made"] == "host-sync"
    assert (recs["analysis.jit_audit"]["ok"], recs["analysis.jit_audit"]["recompiles"]) == (1, 0)
