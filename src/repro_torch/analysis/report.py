"""Findings rendering and the lint's JSON document. Stands for
``repro/analysis/report.py``.

The document holds the per-instantiation shared-memory and register table
(``analysis.smem``; empty on the CPU, where no library is built), the rule
list, every finding (waived and info ones included: the audit trail) and a
summary. It is written only where the lint's ``--json`` says; the repo's
``ANALYSIS.json`` is the reference package's artifact and is not this.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, List

from repro_torch.analysis.rules import RULES, Finding

SCHEMA = "repro_torch.analysis/v1"

_SEV_ORDER = {"error": 0, "warning": 1, "info": 2}


def sort_findings(findings: List[Finding]) -> List[Finding]:
    return sorted(findings, key=lambda f: (_SEV_ORDER[f.severity], f.rule,
                                           f.entrypoint, f.where))


def summarize(findings: List[Finding]) -> Dict[str, int]:
    out = {"errors": 0, "warnings": 0, "info": 0}
    for f in findings:
        out[{"error": "errors", "warning": "warnings", "info": "info"}[f.severity]] += 1
    return out


def render_table(rows: List[Dict]) -> List[str]:
    lines = ["per-instantiation resources (H100 budget: 232448 B shared a block, "
             "255 registers a thread, 65536 a block, no local memory, no stack):"]
    for row in rows:
        mark = "ok" if row["ok"] else "OVER BUDGET"
        dyn = "not launched" if row["dynamic_smem"] is None else f"{row['dynamic_smem']}"
        lines.append(
            f"  rows {','.join(map(str, row['rows'])) or '-':7s} {row['library']:15s} "
            f"{row['kernel'][:96]:96s} reg={row['reg']:3d} threads={row['threads']} "
            f"static={row['static_smem']} dynamic={dyn} local={row['local']} "
            f"stack={row['stack']} [{mark}]")
    return lines


def render(findings: List[Finding], smem_rows: List[Dict], entrypoints: List[str]) -> str:
    lines = [f"repro_torch.analysis: {len(entrypoints)} entry points, {len(RULES)} rules, "
             f"{len(smem_rows)} kernel instantiations in the shared-memory table", ""]
    if smem_rows:
        lines += render_table(smem_rows) + [""]
    s = summarize(findings)
    if not findings:
        lines.append("findings: none")
    else:
        lines.append(f"findings: {s['errors']} error(s), {s['warnings']} warning(s), "
                     f"{s['info']} info")
        lines += [f"  {f}" for f in sort_findings(findings)]
    return "\n".join(lines)


def to_doc(findings: List[Finding], smem_rows: List[Dict], entrypoints: List[str],
           device: str, budget: Dict) -> Dict:
    return {
        "schema": SCHEMA,
        "generated_by": "python -m repro_torch.analysis.lint --json PATH",
        "device": device,
        "rules": list(RULES),
        "budget": dict(budget),
        "entrypoints": list(entrypoints),
        "smem_kernels": smem_rows,
        "findings": [dataclasses.asdict(f) for f in sort_findings(findings)],
        "summary": dict(summarize(findings), entrypoints=len(entrypoints),
                        kernels=len(smem_rows)),
    }


def write_analysis(path: str, doc: Dict) -> None:
    with open(path, "w") as f:
        json.dump(doc, f, indent=1, default=str)
        f.write("\n")
