"""The port's analysis rules (``repro_torch.analysis``) on the CPU, where the
kernels' plain versions run at the same entry points the kernels do:

- the call recorder at the kernel boundary (what it keeps, and that it
  keeps nothing with no recorder open);
- each of the six rules clean on the real entry points (quick: dense +
  ssm, one sweep shared by the module) and failing on a seeded fault;
- the shared-memory table's parsing, budget and coverage of rows 1-12 and
  of every kernel the CUDA sources define (the card's own table is read by
  ``chip_smoke.py``);
- the lint CLI's exit codes and its JSON;
- the names the reference's analysis declares (rule order, waivers, the
  families swept) as the port keeps them.
"""
import dataclasses
import json

import pytest
import torch

from repro.analysis import entrypoints as jeps
from repro.analysis import rules as jrules
from repro_torch.analysis import entrypoints as eps
from repro_torch.analysis import kernel_calls as kc
from repro_torch.analysis import lint
from repro_torch.analysis import rules as R
from repro_torch.analysis import smem
from repro_torch.core import forward_grad as tfg
from repro_torch.kernels import calls, dispatch, launch_counts
from repro_torch.kernels.swa_attention import ops as sops
from repro_torch.models import transformer as ttf

from port_reference import unoptimized_reference  # noqa: F401 (autouse)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def quick_traces():
    """The quick sweep (dense + ssm and the shared entry points), run once."""
    return eps.sweep(quick=True, device="cpu")


def _by_name(traces, name):
    return next(t for t in traces if t.name == name)


def _errors(findings):
    return [f for f in findings if f.severity == "error"]


# ---------------------------------------------------------------------------
# the recorder
# ---------------------------------------------------------------------------

def test_recorder_records_the_kernel_boundary():
    q, k, v = (torch.randn(1, 2, 8, 16) for _ in range(3))
    sops.swa_attention(q, k, v)                       # no recorder open
    assert calls.recording is None
    with calls.record_calls() as rec:
        sops.swa_attention(q, k, v)
        with dispatch.forward_ad_region():
            sops.swa_attention_mt_tangents(q, k, v, q[None], k[None], v[None])
    assert calls.recording is None
    assert [(c.name, c.ran, c.route, c.forward_ad) for c in rec] == [
        ("swa_attention", "plain", "plain", False),
        ("swa_attention_mt", "plain", "plain", True)]
    assert rec[0].inputs == (((1, 2, 8, 16), "float32"),) * 3
    assert rec[1].outputs == (((1, 1, 2, 8, 16), "float32"),)
    assert kc.kernel_family(rec[1]) == "swa_attention"


def test_tangent_stack_queries():
    call = calls.KernelCall("swa_attention_mt", "kernel", "tc", (),
                            (((4, 2, 3, 5, 8), "bfloat16"),), True)
    y = (2, 3, 5, 8)
    assert kc.tangent_stack_size(4, y) == 4 * 2 * 3 * 5 * 8
    assert len(kc.tangent_stack_outputs([call], 4, y)) == 1
    assert kc.tangent_stack_outputs([call], 4, y, family="wkv6_scan") == []
    with pytest.raises(AssertionError, match="tangent-stack"):
        kc.assert_no_tangent_stack([call], 4, y)


# ---------------------------------------------------------------------------
# rule 1: tangent-materialization
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", ["dense", "ssm"])
def test_tangent_rule_clean_on_fused_and_teeth_on_standard(quick_traces, family):
    for task in ("lm", "cls"):
        fused = _by_name(quick_traces, f"loss.{family}.{task}.fused")
        std = _by_name(quick_traces, f"loss.{family}.{task}.standard")
        assert R.check_tangent_stack(fused.name, fused.calls, fused.K, fused.y_shape,
                                     family=fused.site_family) == []
        teeth = R.record_expected_stack(std.name, std.calls, std.K, std.y_shape,
                                        family=std.site_family)
        assert [f.severity for f in teeth] == ["info"]
        # the stack the standard route writes is exactly what the fused one must not
        assert _errors(R.check_tangent_stack(std.name, std.calls, std.K, std.y_shape,
                                             family=std.site_family))


def test_tangent_rule_catches_a_site_that_materializes(monkeypatch):
    """A fused route whose site forms the (K, ...) tangents with the
    multi-tangent kernel and contracts them in plain ops (no epilogue)."""
    def materializing(loss_fn, gy, site_args, argdots):
        q, k, v = site_args
        yd = dispatch.swa_attend(q, k, v, loss_fn.window)   # primal; tangents below
        outd = dispatch._SwaTangent.apply(q, k, v, *argdots, loss_fn.window)
        return torch.sum(gy.float() * outd.float()) + 0 * yd.sum()
    monkeypatch.setattr(tfg, "_site_contract", materializing)
    fused, _ = eps.loss_traces("dense", "cls", K=4, device="cpu")
    found = _errors(R.check_tangent_stack(fused.name, fused.calls, fused.K,
                                          fused.y_shape, family=fused.site_family))
    assert any("ONE" in f.message for f in found)


# ---------------------------------------------------------------------------
# rule 2: smem-budget
# ---------------------------------------------------------------------------

RES_TEXT = """
Resource usage:
 Common:
  GLOBAL:0
 Function _Z13swa_tc_kernelILi8ELb0EEvv:
  REG:128 STACK:0 SHARED:0 LOCAL:0 CONSTANT[0]:600 TEXTURE:0 SURFACE:0 SAMPLER:0
 Function _Z16sum_parts_kernelILi32EEvv:
  REG:16 STACK:0 SHARED:128 LOCAL:0 CONSTANT[0]:380 TEXTURE:0 SURFACE:0 SAMPLER:0
"""


def _trace(name, block, shared):
    return {"traceEvents": [{"cat": "kernel", "name": name,
                             "args": {"block": block, "shared memory": shared,
                                      "registers per thread": 128}}]}


def test_smem_table_parses_joins_and_checks_the_budget():
    use = smem.parse_res_usage(RES_TEXT)
    tc, parts = "_Z13swa_tc_kernelILi8ELb0EEvv", "_Z16sum_parts_kernelILi32EEvv"
    assert use[tc] == {"reg": 128, "stack": 0, "shared": 0, "local": 0}
    assert smem.demangle(tc) == "void swa_tc_kernel<8, false>()"
    assert smem.kernel_function(tc, "swa_attention") == "swa_tc_kernel"
    # the trace's spelling and the library's meet in ``name_key``
    launched = smem.launches_from_trace(_trace("void swa_tc_kernel<8, false>()",
                                               [128, 1, 1], 40960))
    assert smem.name_key("void <unnamed>::swa_tc_kernel<(int)8, (bool)0>()") in launched
    rows = smem.smem_table({"swa_attention": use}, launched)
    assert [(r["function"], r["rows"], r["launched"], r["threads"], r["dynamic_smem"],
             r["ok"]) for r in rows] == [
        ("swa_tc_kernel", [2], True, 128, 40960, True),
        ("sum_parts_kernel", [4], False, None, None, True)]
    assert smem.unmatched_launches(rows, launched) == []
    twice = smem.merge_launches(launched, smem.launches_from_trace(
        _trace("void swa_tc_kernel<8, false>()", [64, 1, 1], 50000)))
    assert [(r["threads"], r["smem"], r["launches"]) for r in twice.values()] == [
        (128, 50000, 2)]
    assert R.check_smem_rows("t", rows) == []
    assert [f.where for f in R.check_smem_coverage("t", rows, (2, 4))] == ["row 4"]
    # seeded faults: spills, a stack frame, registers a block, shared memory
    over = dict(use)
    over[tc] = dict(use[tc], local=8, stack=16, reg=255)
    rows = smem.smem_table({"swa_attention": over}, smem.launches_from_trace(
        _trace("void swa_tc_kernel<8, false>()", [512, 1, 1], 240000)))
    (bad,) = _errors(R.check_smem_rows("t", rows))
    for what in ("local memory", "stack frame", "registers a block", "shared memory"):
        assert what in bad.message
    stray = smem.launches_from_trace(_trace("void swa_tc_kernel<4, true>()", [64, 1, 1], 0))
    assert smem.unmatched_launches(rows, stray) == ["void swa_tc_kernel<4, true>()"]
    with pytest.raises(KeyError, match="shared memory"):
        smem.launches_from_trace({"traceEvents": [{"cat": "kernel", "name": "k",
                                                   "args": {}}]})


def test_smem_rule_waives_only_the_recorded_spills():
    waived, other = "_Z13swa_tc_kernelILi6ELb0EEvv", "_Z13swa_tc_kernelILi4ELb0EEvv"
    use = {fn: {"reg": 168, "stack": 8, "shared": 0, "local": 0} for fn in (waived, other)}
    rows = smem.smem_table({"swa_attention": use})
    found = R.check_smem_rows("t", rows)
    assert [(f.severity, f.where) for f in found] == [
        ("error", "void swa_tc_kernel<4, false>()"),
        ("info", "void swa_tc_kernel<6, false>()")]
    assert "stack frame" in found[0].message and "waived" in found[1].message
    # a waiver covers the spill alone
    use[waived] = dict(use[waived], reg=256)
    errors = {f.where: f.message
              for f in _errors(R.check_smem_rows("t", smem.smem_table({"swa_attention": use})))}
    bad = errors["void swa_tc_kernel<6, false>()"]
    assert "registers a thread" in bad and "stack frame" not in bad
    fns = {fn for _, fn, _ in smem.KERNEL_ROWS}
    assert all(tid.split("<")[0] in fns for tid in smem.SPILL_WAIVERS)


def test_smem_rule_catches_kernel_calls_the_trace_missed():
    def call(name, route="tc"):
        return calls.KernelCall(name, "plain" if route == "plain" else "kernel", route,
                                (), (), False)
    records = [call("swa_attention"), call("swa_attention"), call("swa_attention_mt_jvps"),
               call("lora_dual_mt", "plain")]
    launched = smem.merge_launches(*(smem.launches_from_trace(_trace(n, [128, 1, 1], 0))
                                     for n in ("void swa_tc_kernel<4, false>()",
                                               "void swa_tc_kernel<4, false>()",
                                               "void swa_tc_jvps_kernel<4, false>()")))
    assert R.check_smem_traced("t", records, launched) == []
    assert set(smem.CALL_ROWS) == set(launch_counts())
    assert sorted(smem.CALL_ROWS.values()) == list(smem.ALL_ROWS)
    # seeded faults: a primal launch and the contraction's launch the trace lost
    # (its partial sums do not stand in for it)
    fewer = smem.merge_launches(*(smem.launches_from_trace(_trace(n, [128, 1, 1], 0))
                                  for n in ("void swa_tc_kernel<4, false>()",
                                            "void sum_parts_kernel<32>()")))
    found = _errors(R.check_smem_traced("t", records, fewer))
    assert [(f.where, f.data) for f in found] == [
        ("row 2", {"calls": 2, "traced": 1}), ("row 4", {"calls": 1, "traced": 0})]


def test_kernel_table_covers_every_row_and_every_source_kernel():
    """The counterpart of the reference's representative-table test: every
    ``__global__`` kernel of each library's source maps to a row of the
    kernel table, and rows 1-12 are all served."""
    fns = smem.csrc_kernel_functions()
    assert set(fns) == {"lora_dual", "lora_dual_multi", "swa_attention", "mamba2_ssd",
                        "mamba2_scan", "wkv6_scan", "wkv6_chunk"}
    unmapped = [(lib, f) for lib, names in fns.items() for f in names
                if not smem.rows_of(lib, f)]
    assert unmapped == []
    served = {r for lib, names in fns.items() for f in names for r in smem.rows_of(lib, f)}
    assert sorted(served) == list(smem.ALL_ROWS)


# ---------------------------------------------------------------------------
# rule 3: transpose-reachability
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", ["dense", "ssm"])
def test_transpose_rule_clean_on_grad_outside_region(quick_traces, family):
    t = _by_name(quick_traces, f"grad.{family}.cls")
    assert t.calls == [] and t.meta["error"] is None
    assert R.check_transpose_reachability(t.name, t.calls, t.meta["error"]) == []


def test_transpose_rule_catches_a_kernel_under_reverse_mode(monkeypatch):
    """A model whose attention takes the dispatched kernel outside the
    forward-AD region: reverse mode reaches its entry point."""
    monkeypatch.setattr(dispatch, "in_forward_ad_region", lambda: True)
    monkeypatch.setattr("repro_torch.models.attention.dispatch.in_forward_ad_region",
                        lambda: True)
    (t,) = eps.grad_guard_traces("dense", device="cpu")
    assert "NotImplementedError" in t.meta["error"]     # no reverse rule: it crashed
    found = _errors(R.check_transpose_reachability(t.name, t.calls, t.meta["error"]))
    assert {f.data.get("kernel") for f in found} == {"swa_attention", None}


# ---------------------------------------------------------------------------
# rule 4: donation
# ---------------------------------------------------------------------------

def test_donation_rule_clean_on_serving_and_round_steps(quick_traces):
    names = ["serve.prefill.dense", "serve.decode.dense", "serve.prefill.ssm",
             "serve.decode.ssm", "serving.decode1.dense", "serving.scatter.dense",
             "serving.decode.dense", "engine.round_step", "train.round_step"]
    for name in names:
        t = _by_name(quick_traces, name)
        found = R.check_donation(name, t.meta["before"], t.meta["after"])
        assert [f.severity for f in found] == ["info"], (name, found)


def test_donation_rule_catches_a_copied_cache_and_honours_waivers(monkeypatch):
    real = ttf._write_rows

    def copying(cache, k, v, index):     # a decode step that writes into copies
        for name in list(cache):
            cache[name] = cache[name].clone()
        real(cache, k, v, index)
    monkeypatch.setattr(ttf, "_write_rows", copying)
    t = next(t for t in eps.serve_lowered("dense", device="cpu")
             if t.name == "serve.decode.dense")
    found = _errors(R.check_donation(t.name, t.meta["before"], t.meta["after"]))
    assert {f.where for f in found} == {"/k", "/v"}
    waived = R.check_donation("serve.tokenwise_default_decode", t.meta["before"],
                              t.meta["after"])
    assert waived and all(f.severity == "info" and f.data["waived"] for f in waived)


# ---------------------------------------------------------------------------
# rule 5: dtype-policy
# ---------------------------------------------------------------------------

def test_dtype_rule_clean_on_real_calls_sources_and_wire_table(quick_traces):
    for t in quick_traces:
        if t.kind in ("fused_loss", "standard_loss"):
            assert R.check_dtype_policy(t.name, t.calls) == []
    assert any(kc.is_contraction(c) for t in quick_traces for c in t.calls)
    assert R.check_csrc_accumulators() == []
    assert R.check_wire_dtypes() == []


def test_dtype_rule_catches_seeded_half_accumulators(tmp_path, monkeypatch):
    call = calls.KernelCall("swa_attention_mt_jvps", "kernel", "tc", (),
                            (((4,), "float32"), ((8, 4), "bfloat16")), True)
    assert [f.data["dtype"] for f in R.check_dtype_policy("t", [call])] == ["bfloat16"]
    (tmp_path / "k.cu").write_text(
        '  asm("mma.sync.aligned.m16n8k16.row.col.f16.f16.f16.f16 ...");\n'
        '  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 ...");\n'
        "  wmma::fragment<wmma::accumulator, 16, 16, 16, half> acc;\n")
    found = R.check_csrc_accumulators(csrc=tmp_path)
    assert [f.where for f in _errors(found)] == ["k.cu:1", "k.cu:3"]
    from repro_torch.fl.runtime import messages
    monkeypatch.setitem(messages.WIRE_DTYPES, "bf16", messages.WIRE_DTYPES["fp32"])
    assert [f.where for f in _errors(R.check_wire_dtypes())] == ["WIRE_DTYPES[bf16]"]


# ---------------------------------------------------------------------------
# rule 6: telemetry-neutrality
# ---------------------------------------------------------------------------

def test_telemetry_rule_clean_on_engines_and_catches_a_difference(quick_traces):
    pairs = [t for t in quick_traces if t.kind == "telemetry_pair"]
    assert {t.name for t in pairs} == {"telemetry.engine.round_step.ssm",
                                       "telemetry.serving.engine.dense"}
    for t in pairs:
        found = R.check_telemetry_neutrality(t.name, t.meta["calls_off"],
                                             t.meta["calls_on"], t.meta["outputs_equal"])
        assert [f.severity for f in found] == ["info"]
        assert t.meta["calls_off"]
    off = pairs[0].meta["calls_off"]
    extra = off + [dataclasses.replace(off[-1], route="other")]
    assert _errors(R.check_telemetry_neutrality("t", off, extra, True))
    assert _errors(R.check_telemetry_neutrality("t", off, off, False))


# ---------------------------------------------------------------------------
# the lint CLI and the reference's names
# ---------------------------------------------------------------------------

def test_lint_cli_exit_codes_and_json(quick_traces, monkeypatch, tmp_path, capsys):
    monkeypatch.setattr(eps, "sweep", lambda **kw: quick_traces)
    out = tmp_path / "a.json"
    assert lint.main(["--device", "cpu", "--quick", "--json", str(out)]) == 0
    doc = json.loads(out.read_text())
    assert doc["rules"] == list(R.RULES) and doc["summary"]["errors"] == 0
    assert doc["summary"]["entrypoints"] == len(quick_traces)
    warn = R.Finding("dtype-policy", "warning", "t", "w", "seeded warning")
    monkeypatch.setattr(R, "check_wire_dtypes", lambda: [warn])
    assert lint.main(["--device", "cpu", "--quick"]) == 0
    assert lint.main(["--device", "cpu", "--quick", "--strict"]) == 1
    monkeypatch.setattr(R, "check_wire_dtypes",
                        lambda: [dataclasses.replace(warn, severity="error")])
    assert lint.main(["--device", "cpu", "--quick"]) == 1
    assert "1 error(s)" in capsys.readouterr().out


def test_names_follow_the_reference():
    assert R.RULES == tuple("smem-budget" if r == "vmem-budget" else r
                            for r in jrules.RULES)
    assert R.DONATION_WAIVERS == jrules.DONATION_WAIVERS
    assert [f.name for f in dataclasses.fields(R.Finding)] == \
        [f.name for f in dataclasses.fields(jrules.Finding)]
    assert set(jeps.ARCHS) <= set(eps.ARCHS) and eps.QUICK_FAMILIES == jeps.QUICK_FAMILIES
    assert {k: jeps.ARCHS[k] for k in jeps.ARCHS} == {k: eps.ARCHS[k] for k in jeps.ARCHS}
    assert eps.SITE_FAMILY == jeps.SITE_FAMILY and eps.TASKS == jeps.TASKS
