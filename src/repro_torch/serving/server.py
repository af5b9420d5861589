"""LogAct-governed serving: batched generation requests through the
Intent -> Vote -> Commit -> Execute machinery.

Requests arrive as ``Mail`` entries. Two serving disciplines share this
module, as in the reference:

* **Static batching** (``ServePlanner`` / ``serve_batch``): all pending
  mail becomes ONE closed-loop generation intent; requests arriving
  mid-generation wait for the whole batch to finish. ``h_serve_batch``
  runs ``Model.prefill`` and ``Model.decode_step`` for every family, with
  the reference's quirks kept: prompts are left-padded with token 0
  (which neither dense attention nor an SSM masks), optional
  ``pad_batch`` dummy rows are dropped from the result, the argmax runs
  over the padded vocab, and the modality frontends are stubs (zero
  ``frame_embed`` of ``enc_seq`` rows for audio, zero ``patch_embed`` of
  ``n_frontend_tokens`` rows for vlm, whose decode positions then start
  past the prefix).

* **Continuous batching** (``ContinuousServePlanner`` / ``serve_step``):
  the planner is a step-level scheduler over the paged decode engine
  (``serving/engine.py``): every intent covers one single-token decode
  step plus the admissions joining it, so new requests merge into the
  in-flight batch at the next step. Each admission rides in the intent
  ``args`` — visible to voters *before* any prefill runs — which turns
  the paper's intent-before-execution hook into admission control:
  per-tenant denylists/quotas and queue-depth bounds are ordinary
  ``RuleVoter`` rules (``SERVE_ADMISSION_RULES``), and a vetoed admission
  is re-proposed solo once and then dropped as rejected.

The planners and the rules are pure Python, carried over unchanged from
the reference. The continuous agent is also the ``AgentKernel`` spawn
image ``serving-continuous`` (``core/kernel.py``): the image takes the
reference's arguments, with ``device`` passed on through ``**kw``, so a
spawned agent runs on the card unless ``device="cpu"`` is given.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..configs.base import ArchConfig
from ..core.agent import LogActAgent
from ..core.driver import Planner
from ..core.kernel import register_image
from ..core.voter import VoteDecision
from ..device import resolve_device
from ..models.model import Model
from ..models.params import init_params
from .engine import PagedEngine


@dataclass
class ServeEnv:
    """Executor environment of the static discipline: the model and its
    parameters, drawn at the first ``serve_batch`` unless given. The
    reference's jitted ``prefill_fn`` / ``decode_fn`` have no counterpart:
    the model's methods run eagerly."""

    model: Model
    params: Any = None
    max_new_tokens: int = 16
    device: Any = None

    def ensure_initialized(self, seed: int = 0) -> None:
        if self.params is None:
            dev = resolve_device(self.device)
            self.params = init_params(
                self.model.cfg, torch.Generator(device=dev).manual_seed(seed),
                dev)


def pad_prompts(prompts, pad_batch: Optional[int] = None) -> np.ndarray:
    """The static batch's tokens (rows, longest prompt): each prompt
    left-padded with token 0, then dummy all-0 rows up to ``pad_batch``
    (the reference pads so that every batch hits one compiled shape)."""
    prompts = [np.asarray(p, np.int64) for p in prompts]
    plen = max(len(p) for p in prompts)
    toks = np.zeros((max(len(prompts), int(pad_batch or 0)), plen), np.int64)
    for i, p in enumerate(prompts):
        toks[i, plen - len(p):] = p
    return toks


def stub_batch(cfg: ArchConfig, tokens: torch.Tensor):
    """The static batch of ``tokens`` (rows, plen) with the stubbed
    modality frontends (zero ``frame_embed`` (rows, enc_seq, D) for audio,
    zero ``patch_embed`` (rows, n_frontend_tokens, D) for vlm, fp32 on the
    tokens' device), and the position of its first decoded token: the
    prefilled length (vlm prefixes its patch tokens ahead of the text)."""
    rows, plen = tokens.shape
    batch = {"tokens": tokens}
    if cfg.family == "audio":
        batch["frame_embed"] = torch.zeros((rows, cfg.enc_seq, cfg.d_model),
                                           dtype=torch.float32,
                                           device=tokens.device)
    if cfg.family == "vlm":
        batch["patch_embed"] = torch.zeros(
            (rows, cfg.n_frontend_tokens, cfg.d_model), dtype=torch.float32,
            device=tokens.device)
        return batch, plen + cfg.n_frontend_tokens
    return batch, plen


def h_serve_batch(args: Dict[str, Any], env: ServeEnv) -> Dict[str, Any]:
    env.ensure_initialized()
    new_tokens = int(args.get("max_new_tokens", env.max_new_tokens))
    bsz = len(args["prompts"])
    toks = pad_prompts(args["prompts"], args.get("pad_batch"))
    plen = toks.shape[1]
    batch, pos0 = stub_batch(env.model.cfg, torch.from_numpy(toks).to(
        env.params["embed"].device))
    logits, cache = env.model.prefill(env.params, batch,
                                      extra_cache=new_tokens)
    # argmax over the padded vocab (pad logits are -1e30)
    tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
    out = [tok]
    for t in range(new_tokens - 1):
        logits, cache = env.model.decode_step(env.params, cache, tok,
                                              pos0 + t)
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
        out.append(tok)
    gen = torch.cat(out, dim=1).cpu().numpy()[:bsz]  # drop pad rows
    res = {"generated": gen.tolist(), "batch": bsz,
           "prefill_len": plen, "new_tokens": new_tokens}
    if "req_ids" in args:  # per-request attribution
        res["req_ids"] = list(args["req_ids"])
    return res


SERVE_HANDLERS = {"serve_batch": h_serve_batch}


class ServePlanner(Planner):
    """Batches all pending request mail into one serve_batch intention."""

    def __init__(self, max_batch: int = 8,
                 pad_batch: Optional[int] = None):
        self.max_batch = max_batch
        self.pad_batch = pad_batch
        self.served: int = 0
        self._req_n = 0

    def propose(self, context: Dict[str, Any]) -> Dict[str, Any]:
        pending: List[Dict[str, Any]] = []
        for m in context.get("mail", []):
            if "prompt_tokens" in m:
                pending.append(m)
        # also pick up requests that arrived while we were executing
        for h in context.get("history", []):
            if h.get("role") == "mail" and "prompt_tokens" in h["body"] \
                    and not h["body"].get("_served"):
                pending.append(h["body"])
        if not pending:
            return {"done": True, "note": "queue empty"}
        batch = pending[: self.max_batch]
        rids = []
        for b in batch:
            b["_served"] = True
            rids.append(b.get("req_id") or f"req-{self._req_n}")
            self._req_n += 1
        self.served += len(batch)
        args: Dict[str, Any] = {"prompts": [b["prompt_tokens"]
                                            for b in batch],
                                "req_ids": rids}
        if self.pad_batch:
            args["pad_batch"] = self.pad_batch
        return {"intent": {"kind": "serve_batch", "args": args},
                "note": f"serving batch of {len(batch)}"}


def build_serving_agent(cfg: ArchConfig, *, bus=None, voters=(),
                        max_batch: int = 8,
                        pad_batch: Optional[int] = None,
                        agent_id: str = "server", use_kernel: bool = True,
                        device=None) -> LogActAgent:
    """A governed static-batching serving agent. ``device=None`` means the
    card and raises without CUDA; the parameters are drawn at the first
    ``serve_batch`` unless set on ``agent.executor.env.params`` before."""
    env = ServeEnv(model=Model(cfg, dtype=torch.float32,
                               use_kernel=use_kernel),
                   device=resolve_device(device))
    return LogActAgent(bus=bus,
                       planner=ServePlanner(max_batch, pad_batch=pad_batch),
                       env=env, handlers=SERVE_HANDLERS,
                       voters=list(voters), agent_id=agent_id)


# ---------------------------------------------------------------------------
# Continuous batching: serve_step scheduler over the paged engine
# ---------------------------------------------------------------------------

@dataclass
class ContinuousServeEnv:
    """Executor environment owning the paged decode engine."""

    cfg: ArchConfig
    max_batch: int = 8
    num_pages: int = 128
    page_size: int = 16
    max_new_tokens: int = 16
    use_kernel: bool = True
    seed: int = 0
    max_pages_per_seq: Optional[int] = None
    device: Any = None
    engine: Optional[PagedEngine] = None

    def ensure_initialized(self) -> None:
        if self.engine is None:
            self.engine = PagedEngine(
                self.cfg, max_batch=self.max_batch,
                num_pages=self.num_pages, page_size=self.page_size,
                seed=self.seed, use_kernel=self.use_kernel,
                max_pages_per_seq=self.max_pages_per_seq,
                device=self.device)


def h_serve_step(args: Dict[str, Any], env: ContinuousServeEnv
                 ) -> Dict[str, Any]:
    """One scheduler step: admit the proposed requests (prefill into the
    paged pool), then run one decode step for every in-flight lane.
    Admissions that don't fit (no free lane / pool pages) are reported
    ``denied`` — capacity backpressure, distinct from a voter veto."""
    env.ensure_initialized()
    eng = env.engine
    admitted, denied = [], []
    for r in args.get("admit", []):
        ok = eng.admit(r["req_id"], r["prompt_tokens"],
                       int(r.get("max_new_tokens", env.max_new_tokens)),
                       tenant=r.get("tenant", "default"))
        (admitted if ok else denied).append(r["req_id"])
    finished = eng.step()
    return {"step": int(args.get("step", -1)),
            "admitted": admitted, "denied": denied,
            "finished": [{"req_id": s.req_id, "generated": s.tokens,
                          "tenant": s.tenant} for s in finished],
            "n_inflight": eng.n_inflight, "pool": eng.pool.stats()}


SERVE_HANDLERS["serve_step"] = h_serve_step


class ContinuousServePlanner(Planner):
    """Step-level scheduler: one ``serve_step`` intent per decode step.

    Host-side state is rebuilt from the driver's context alone (mail +
    the trailing result/abort of the previous step), so the planner stays
    replay-compatible: a replayed lineage reuses logged InfOuts and never
    consults this object's state out of order.

    Veto handling (voters as admission control): when a step carrying
    admissions is aborted, each rider is re-proposed *solo* so the veto
    attributes to a single request; a solo admission that is aborted
    again is dropped as ``rejected``. Decode of already-admitted
    sequences always resumes on the next proposal (an abort stops the
    step, not the service).
    """

    def __init__(self, max_batch: int = 8, admit_per_step: int = 0,
                 max_new_tokens: int = 16):
        self.max_batch = max_batch
        self.admit_per_step = admit_per_step or max_batch
        self.max_new_tokens = max_new_tokens
        self.queue: List[Dict[str, Any]] = []
        self.outputs: Dict[str, List[int]] = {}   # finished req -> tokens
        self.rejected: List[str] = []             # dropped by voter veto
        self.vetoes: Dict[str, int] = {}
        self.n_inflight = 0
        self.step = 0
        self._awaiting: Optional[List[Dict[str, Any]]] = None  # admits out
        self._req_n = 0
        self._consec_fail = 0

    # -- context ingestion ---------------------------------------------------
    def _ingest_mail(self, m: Dict[str, Any]) -> None:
        if "prompt_tokens" not in m or m.get("_sched"):
            return
        m["_sched"] = True  # driver reuses the dict: flag survives
        rid = m.get("req_id") or f"req-{self._req_n}"
        self._req_n += 1
        self.queue.append({
            "req_id": rid,
            "tenant": m.get("tenant", "default"),
            "prompt_tokens": list(m["prompt_tokens"]),
            "max_new_tokens": int(m.get("max_new_tokens",
                                        self.max_new_tokens))})

    def _resolve_last(self, history: List[Dict[str, Any]]) -> None:
        """Fold the previous step's outcome (the trailing result/abort —
        the driver admits one intent in flight at a time)."""
        if self._awaiting is None and self.n_inflight == 0:
            return
        last = next((h for h in reversed(history)
                     if h.get("role") in ("result", "abort")), None)
        proposed, self._awaiting = self._awaiting or [], None
        by_id = {r["req_id"]: r for r in proposed}
        if last is None:
            self.queue = proposed + self.queue
            return
        if last["role"] == "abort" or not last["body"].get("ok", True):
            # voter veto (or handler failure): re-propose riders solo,
            # drop repeat offenders
            self._consec_fail += 1
            for r in proposed:
                n = self.vetoes[r["req_id"]] = \
                    self.vetoes.get(r["req_id"], 0) + 1
                if n >= 2:
                    self.rejected.append(r["req_id"])
                else:
                    self.queue.insert(0, r)
            return
        self._consec_fail = 0
        v = last["body"].get("value", {})
        for rid in v.get("denied", ()):  # capacity: requeue, retry later
            if rid in by_id:
                self.queue.insert(0, by_id[rid])
        for f in v.get("finished", ()):
            self.outputs[f["req_id"]] = f["generated"]
        self.n_inflight = int(v.get("n_inflight", self.n_inflight))

    # -- the scheduling decision --------------------------------------------
    def propose(self, context: Dict[str, Any]) -> Dict[str, Any]:
        for m in context.get("mail", []):
            self._ingest_mail(m)
        for h in context.get("history", []):
            if h.get("role") == "mail":
                self._ingest_mail(h["body"])
        self._resolve_last(context.get("history", []))
        if not self.queue and self.n_inflight == 0:
            return {"done": True,
                    "note": f"served {len(self.outputs)}, "
                            f"rejected {len(self.rejected)}"}
        if self._consec_fail >= 25:
            # every step is being vetoed / failing (e.g. a policy that
            # rejects all serve_steps): park instead of spinning
            return {"done": True,
                    "note": "stalled: 25 consecutive aborted steps"}
        # any previously-vetoed rider goes solo so a repeat veto
        # attributes to it alone
        cap = min(self.admit_per_step,
                  max(0, self.max_batch - self.n_inflight))
        admit: List[Dict[str, Any]] = []
        for r in list(self.queue):
            if len(admit) >= cap:
                break
            if self.vetoes.get(r["req_id"]) and admit:
                break
            self.queue.remove(r)
            admit.append(r)
            if self.vetoes.get(r["req_id"]):
                break
        self._awaiting = admit
        self.step += 1
        return {"intent": {"kind": "serve_step",
                           "args": {"step": self.step, "admit": admit,
                                    "n_inflight": self.n_inflight}},
                "note": f"step {self.step}: +{len(admit)} admit, "
                        f"{self.n_inflight} in flight"}


# -- admission-control voter rules (paper: intent-before-execution as QoS) --

def rule_serve_tenant_denylist(body, pol) -> Optional[VoteDecision]:
    """Block admissions from denylisted tenants."""
    if body["kind"] != "serve_step":
        return None
    deny = set(pol.get("tenant_denylist", ()) or ())
    for r in body.get("args", {}).get("admit", ()):
        if r.get("tenant", "default") in deny:
            return VoteDecision(False, f"tenant {r.get('tenant')!r} denied "
                                       f"(req {r.get('req_id')})")
    return None


def rule_serve_admission_cap(body, pol) -> Optional[VoteDecision]:
    """Rate-limit admissions per scheduler step."""
    if body["kind"] != "serve_step":
        return None
    cap = pol.get("max_admit_per_step")
    n = len(body.get("args", {}).get("admit", ()))
    if cap is not None and n > int(cap):
        return VoteDecision(False, f"{n} admissions > cap {cap}")
    return None


def rule_serve_inflight_bound(body, pol) -> Optional[VoteDecision]:
    """Bound the declared post-admission batch occupancy."""
    if body["kind"] != "serve_step":
        return None
    bound = pol.get("max_inflight")
    args = body.get("args", {})
    if bound is not None and \
            args.get("n_inflight", 0) + len(args.get("admit", ())) \
            > int(bound):
        return VoteDecision(False, "in-flight bound exceeded")
    return None


def rule_serve_prompt_budget(body, pol) -> Optional[VoteDecision]:
    """Reject admissions whose token budget exceeds the per-request cap."""
    if body["kind"] != "serve_step":
        return None
    cap = pol.get("max_tokens_per_request")
    if cap is None:
        return None
    for r in body.get("args", {}).get("admit", ()):
        tot = len(r.get("prompt_tokens", ())) + \
            int(r.get("max_new_tokens", 0))
        if tot > int(cap):
            return VoteDecision(
                False, f"req {r.get('req_id')}: {tot} tokens > cap {cap}")
    return None


SERVE_ADMISSION_RULES = (rule_serve_tenant_denylist,
                         rule_serve_admission_cap,
                         rule_serve_inflight_bound,
                         rule_serve_prompt_budget)


def build_continuous_serving_agent(cfg: ArchConfig, *, bus=None, voters=(),
                                   max_batch: int = 8, num_pages: int = 128,
                                   page_size: int = 16,
                                   max_new_tokens: int = 16,
                                   use_kernel: bool = True,
                                   max_pages_per_seq: Optional[int] = None,
                                   snapshot_store=None,
                                   agent_id: str = "server",
                                   device=None) -> LogActAgent:
    """A governed continuous-batching serving agent. ``device=None`` means
    the card and raises without CUDA; the engine is built at the first
    ``serve_step``."""
    env = ContinuousServeEnv(cfg=cfg, max_batch=max_batch,
                             num_pages=num_pages, page_size=page_size,
                             max_new_tokens=max_new_tokens,
                             use_kernel=use_kernel,
                             max_pages_per_seq=max_pages_per_seq,
                             device=resolve_device(device))
    planner = ContinuousServePlanner(max_batch=max_batch,
                                     max_new_tokens=max_new_tokens)
    return LogActAgent(bus=bus, planner=planner, env=env,
                       handlers=SERVE_HANDLERS, voters=list(voters),
                       snapshot_store=snapshot_store, agent_id=agent_id)


@register_image("serving-continuous")
def _image_serving_continuous(bus=None, snapshot_store=None,
                              arch: str = "qwen3_4b", smoke_cfg: bool = True,
                              **kw) -> LogActAgent:
    """AgentKernel spawn image: a continuous-batching serving agent on the
    kernel's bus (the smoke config by default; ``device`` rides in
    ``kw``, the card unless told otherwise)."""
    from ..configs.base import get_config, smoke
    cfg = get_config(arch)
    if smoke_cfg:
        cfg = smoke(cfg)
    return build_continuous_serving_agent(
        cfg, bus=bus, snapshot_store=snapshot_store, **kw)
