"""Diagnostic model shared by both analysis passes of the port.

Counterpart of ``src/repro/analysis/diagnostics.py``.  Every check emits
:class:`Diagnostic` records with a *stable* code from the RF1xx (plan) /
RF2xx (program) namespaces.  Codes are append-only: tools and CI parse
them, so a code's meaning never changes once shipped.  The RF1xx entries
are the reference's word for word (``planlint.py`` is its verbatim
copy); the RF2xx entries keep their codes, titles and motivations, are
owned by :mod:`.torchlint`, and state the invariant as the port checks
it over the aten ops of one eager call instead of a jaxpr; RF206 over
the record of the port's collectives (``core/runtime_sharded.py``) that
one run of the mesh sweep's wave loop issues.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any


@dataclasses.dataclass(frozen=True)
class CodeInfo:
    """Catalog entry: the invariant, the shipped bug that motivated it,
    and the pass that owns it."""

    code: str
    owner: str          # "planlint" | "torchlint"
    title: str
    invariant: str
    motivation: str     # which shipped bug class this guards against


CODES: dict[str, CodeInfo] = {c.code: c for c in [
    CodeInfo(
        "RF101", "planlint", "write-write race inside a wave",
        "Within one wave every non-sentinel agent id appears at most "
        "once, and every non-sentinel rho row index appears at most "
        "once — concurrent lanes never scatter to the same node or "
        "rho/rho-tilde row.",
        "Greedy wave grouping must break on a repeated agent; a dropped "
        "break silently merges two activations of one node into a "
        "single parallel commit."),
    CodeInfo(
        "RF102", "planlint", "history-ring slot alias / stale read",
        "Every ring-slot read resolves to the write count implied by "
        "the realized schedule (searchsorted over the sender's "
        "activation stamps), the payload precedes the reader's wave "
        "start, and the realized delay stays within H-1 slots so no "
        "in-flight write aliases an unread slot.",
        "The AD-PSGD bug class: PR 3 shipped a v_hist ring whose slot "
        "arithmetic let a delayed read see a *newer* overwrite of the "
        "slot under D close to H."),
    CodeInfo(
        "RF103", "planlint", "sentinel / index-range leak",
        "Every table index is in range or *exactly* its documented "
        "sentinel (agent==n, rho_gidx==2*e_a, kidx==K, fleet-scaled "
        "variants), sentinel lanes carry zero weight and validity, and "
        "per-wave sizes count exactly the non-sentinel lanes.",
        "PR 6's fleet padding leaked a sentinel into a gather table "
        "where clamping turned it into a silent read of row 0."),
    CodeInfo(
        "RF104", "planlint", "lane-offset bijection after flatten",
        "flatten_plans is invertible: every flat entry lies in its "
        "lane's offset block (or is the fleet sentinel) and un-offsets "
        "bit-for-bit to the stacked per-lane plan; event_start/sizes "
        "are the documented min/sum aggregates.",
        "A wrong lane offset makes lane s read lane s±1's state — the "
        "exact hazard of the PR 5/6 fleet-flattening rewrite."),
    CodeInfo(
        "RF105", "planlint", "Lemma-3 mass-conservation structure",
        "CommPlan weights satisfy Assumption 1 as *tables*: w_diag plus "
        "incoming w_edge mass is 1 per row, a_diag plus outgoing "
        "a_edge mass is 1 per column, diagonals are positive, every "
        "real edge is covered by exactly one receiver (and one sender "
        "for A) table slot, and pad slots are zero.",
        "Lemma 3's sum(z) + sum(rho - rho_buf) == sum(g_prev) "
        "conservation only holds if no edge mass is dropped or double "
        "counted by the gather tables (PR 2's donated-buffer alias "
        "corrupted exactly this ledger)."),
    CodeInfo(
        "RF106", "planlint", "epoch-boundary migration coverage",
        "EpochTrace epochs tile [0, K) contiguously; joined/departed "
        "masks are exactly the membership delta; each epoch's root is "
        "active and a common root of its topology; joiners always have "
        "an active donor; every prev-epoch edge connects nodes that "
        "were active, so migrate_state's settle pass covers all "
        "in-flight mass.",
        "PR 7's migrate_state settles in-flight rho at prev-epoch "
        "receivers — a row map missing an edge strands mass and breaks "
        "the conservation argument across the epoch boundary."),
    CodeInfo(
        "RF201", "torchlint", "host callback inside a scan",
        "No op that reads a tensor's value on the host "
        "(aten._local_scalar_dense: .item(), int(), float() of a tensor) "
        "and no copy from a CUDA tensor to the host runs while the "
        "engine's wave loop runs.",
        "A host round-trip per wave serializes the wavefront loop and "
        "silently destroys the one-launch-per-wave design of PR 6."),
    CodeInfo(
        "RF202", "torchlint", "silent f64/weak-type promotion",
        "No aten op of an engine program outputs a float64/complex128 "
        "tensor under the default f32 policy.",
        "A stray Python float or np.float64 constant upcasts a whole "
        "chain, doubling memory and splitting the dispatch cache key."),
    CodeInfo(
        "RF203", "torchlint", "materialized neighbour-stack broadcast",
        "No materializing op of an engine program (index, index_select, "
        "gather, stack, cat, repeat, or a clone of an expanded view) "
        "allocates a rank>=3 output above the size threshold that is "
        "larger than its largest input; views are not materializations.",
        "The exact pattern PR 6 removed: stacking k neighbour vectors "
        "per lane before reducing, instead of fusing the reduction "
        "into the commit kernel."),
    CodeInfo(
        "RF204", "torchlint", "donation declared but not honored",
        "The engine updates its packed state in place: across a chunk "
        "every state field keeps its data_ptr, shape and dtype, and the "
        "state it returns views those buffers.",
        "PR 2 donated packed state whose layout change made XLA copy "
        "instead of alias — donation became a silent no-op plus a "
        "use-after-donate hazard."),
    CodeInfo(
        "RF205", "torchlint", "dispatch-cache churn",
        "Replaying an engine step with unchanged shapes adds no cache "
        "entries and no misses beyond the expected steady state (the "
        "serving cache), loads no new kernel library, and launches "
        "commit_grid exactly once per non-empty wave.",
        "PR 6's shape-specialized dispatch relies on ONE compile per "
        "fleet shape; a key that includes a varying component "
        "recompiles every chunk."),
    CodeInfo(
        "RF206", "torchlint", "state-sized collective in the mesh body",
        "No collective that one run of the mesh sweep's wave loop "
        "issues outputs as many bytes as one lane group's full-width "
        "node state (S_loc*n*4*p_pad floats) — a rank gets data beyond "
        "its shard only through a collective, and every collective of "
        "the port goes through core/runtime_sharded.py, which records "
        "its output bytes, so this bounds every path to accidental "
        "replication.  The designed per-wave gather reconstructs at "
        "most the mixed iterates (<= threshold/4).",
        "The 'accidentally replicated' failure mode of PR 9's "
        "sharded parameter axis: an all_gather of the packed "
        "(S_loc*n,4,p) state (or a state-sized psum) makes every "
        "device hold the full 100M-parameter fleet again, silently "
        "undoing the model-axis sharding the mesh exists for."),
]}


@dataclasses.dataclass(frozen=True)
class Diagnostic:
    """One finding: a stable code, the artifact it was found in, a
    human message, and machine-readable locators."""

    code: str
    subject: str
    message: str
    data: dict[str, Any] = dataclasses.field(default_factory=dict)

    def to_json(self) -> dict[str, Any]:
        info = CODES.get(self.code)
        return {
            "code": self.code,
            "title": info.title if info else "",
            "owner": info.owner if info else "",
            "subject": self.subject,
            "message": self.message,
            "data": _jsonable(self.data),
        }

    def __str__(self) -> str:
        return f"{self.code} [{self.subject}] {self.message}"


class PlanInvariantError(AssertionError):
    """Raised by the engine `verify_plans=` hooks when any diagnostic
    fires; carries the offending diagnostics."""

    def __init__(self, diagnostics: list[Diagnostic], context: str = ""):
        self.diagnostics = list(diagnostics)
        head = f"{context}: " if context else ""
        lines = "\n  ".join(str(d) for d in self.diagnostics)
        super().__init__(
            f"{head}{len(self.diagnostics)} plan invariant violation(s)"
            f"\n  {lines}")


def _jsonable(obj):
    """Best-effort conversion of numpy scalars/arrays for json.dumps."""
    if isinstance(obj, dict):
        return {str(k): _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if hasattr(obj, "tolist"):
        return obj.tolist()
    if hasattr(obj, "item"):
        return obj.item()
    return obj


def report_json(diagnostics: list[Diagnostic], **extra) -> str:
    doc = dict(extra)
    doc["diagnostics"] = [d.to_json() for d in diagnostics]
    return json.dumps(doc, indent=2, sort_keys=False)
