"""Continuous-batching SpGEMM serving: async submit/poll over bucketed
batched cores, with admission control and a bounded core cache.

The paper's chunked algorithms (Deveci et al., 1804.00695) exist to serve big
multiplies from a small fast memory; the symmetric serving scenario — many
*small* multiplies behind one endpoint — is instead dominated by per-multiply
setup (Nagasaka & Azad, 1804.01698): replanning, repadding, and above all
recompilation. ``SpGEMMService`` amortizes all three (the port of the JAX
package's service; it runs on the card unless it is built with
``device="cpu"``, and takes operands in slow memory):

  * each request gets a per-instance :class:`GeometryEnvelope` for its plan,
    **quantized** (nnz caps rounded up to a quantum, row-nnz bounds to powers
    of two) so near-identical geometries collapse into one *bucket*;
  * each bucket owns one ``(envelope, plan)`` core geometry per microbatch
    width drawn from a bounded **width ladder** (powers of two up to
    ``max_batch`` by default; with ``learn_tail_widths`` recurring flush-tail
    sizes earn exact widths, trading one extra compile for zero padding on
    that tail thereafter);
  * ``submit`` is **async**: it returns an :class:`SpGEMMFuture` (an ``int``
    subclass carrying the request id) immediately; :meth:`poll` flushes any
    bucket whose queue reached a full microbatch or whose oldest request
    exceeds the per-request latency SLO (``slo_s``), :meth:`drain` flushes
    everything. Due buckets execute **oldest-deadline-first**, not dict
    order;
  * **admission control**: ``max_pending`` bounds total queued requests;
    over the bound, ``admission="shed"`` raises :class:`AdmissionError` and
    ``admission="flush"`` drains the oldest-deadline bucket to make room;
  * the **retrace budget** is a real working-set bound: beyond
    ``retrace_budget`` distinct buckets, an idle bucket (empty queue, not
    flushed for ``eviction_hysteresis`` bucket-executions) is **evicted** —
    and because every bucket owns its cores
    (``BackendSpec.make_batched_cores``), eviction drops them and the
    geometries they met; a re-arriving geometry *refaults* (its core counts
    a trace again). With eviction disabled (``eviction_hysteresis=None``,
    the default) new geometries fold into a compatible bucket;
  * responses split **compile time from execution time**: the first flush
    at a new (bucket, width) warms the core on an envelope-shaped
    all-sentinel batch (``compile_s`` — an upper bound that includes one
    envelope-shaped execution and, in a fresh process, the kernel
    libraries' build), so ``exec_s``/``latency_s`` hold no cold start, and
    flush tails pad with the same empty sentinel instances instead of
    re-multiplying a live request;
  * every flush stages fresh C-accumulator stacks, so a response's C never
    shares memory with a later flush; ``donate_buffers`` is the reference's
    flag for donating them to its jitted cores, kept for the same API;
  * a request's operands may lie in slow memory (pinned host memory, on a
    card service): the bucket key carries the request's placement, so a
    flush never mixes spaces, and a bucket with slow operands flushes
    through ``chunked_spgemm_batched``'s copy ring, its sentinel instances
    in the same spaces, or, on a service built with
    ``slow_reads="in_place"``, through its streaming kernel reading the slow
    stacks where they lie (one launch a strip for the whole microbatch;
    the argument is service-wide, so the bucket key does not change).

Every timed span ends in a synchronisation of the service's device, so
``exec_s``, ``compile_s`` and ``latency_s`` end when the card has finished,
not when the launches were issued. ``docs/serving.md`` documents the bucket
lifecycle (create -> dominate -> merge -> evict -> refault) and the knobs.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import time

import numpy as np
import torch

from repro_torch.core import backend_registry
from repro_torch.core.chunk_stream import TRACE_COUNTS, chunked_spgemm_batched
from repro_torch.core.chunking import (
    SLOW_READS, ChunkStats, in_place_refusal, instance_envelope,
)
from repro_torch.core.placement import ALL_FAST, Placement, place, resolve_placement
from repro_torch.core.planner import (
    ChunkPlan, plan_knl, replan_for_latency, select_accumulator_backend,
)
from repro_torch.sparse.csr import (
    CSR, GeometryEnvelope, _NP_DTYPES, csr_from_scipy_like, resolve_device,
)


def plan_key(plan: ChunkPlan) -> tuple:
    """The compile-relevant identity of a plan (cost fields excluded)."""
    return (plan.algorithm, tuple(plan.p_ac), tuple(plan.p_b))


class AdmissionError(RuntimeError):
    """Raised by ``submit`` when the service is over ``max_pending`` and
    admission control is set to shed."""


class SpGEMMFuture(int):
    """Async handle returned by :meth:`SpGEMMService.submit`.

    Subclasses ``int`` (the value is the request id), so callers that sort,
    hash, or compare submit results against ``SpGEMMResponse.req_id`` keep
    working unchanged. ``done()`` reports whether the request's bucket has
    executed; ``result()`` returns the response, draining the service first
    if the request is still queued (drain, not a targeted flush: a budget
    merge may have moved the request between buckets)."""

    def __new__(cls, req_id: int, service: "SpGEMMService"):
        self = super().__new__(cls, req_id)
        self._service = service
        self._response = None
        return self

    def done(self) -> bool:
        return self._response is not None

    def result(self) -> "SpGEMMResponse":
        if self._response is None:
            self._service.drain()
        if self._response is None:
            raise RuntimeError(
                f"request {int(self)} not completed by drain (was it shed?)")
        return self._response


@dataclasses.dataclass(frozen=True)
class SpGEMMRequest:
    req_id: int
    A: CSR
    B: CSR
    submit_s: float          # perf_counter timestamp at submit
    future: SpGEMMFuture | None = dataclasses.field(default=None, compare=False)


@dataclasses.dataclass
class SpGEMMResponse:
    req_id: int
    C: CSR                   # assembled result for this request
    latency_s: float         # submit -> bucket results materialized
    exec_s: float            # wall time of this request's bucket execution
    compile_s: float         # cold-core time paid by this microbatch (0 warm)
    bucket_key: tuple        # (GeometryEnvelope, plan_key, Placement)
    batch_size: int          # true requests in the executed microbatch
    padded_batch: int        # ladder width the microbatch was padded to
    stats: ChunkStats        # modeled copy traffic at envelope-padded sizes


@dataclasses.dataclass
class _Bucket:
    envelope: GeometryEnvelope
    plan: ChunkPlan
    queue: list              # pending SpGEMMRequest
    placement: Placement = ALL_FAST   # where its requests' A, B and C lie
    compiles: int = 0        # new core geometries (traces) while executing
    executions: int = 0      # microbatches run
    served: int = 0          # requests completed
    widths_used: set = dataclasses.field(default_factory=set)
    backend: str | None = None       # resolved executor (None until first run)
    cores: dict | None = None        # bucket-owned core set
    compiled_widths: set = dataclasses.field(default_factory=set)
    last_used: int = 0               # service tick of last submit/flush
    sentinel: tuple | None = None    # cached envelope-shaped empty (A, B)
    exec_ewma: float | None = None   # per-request execution seconds, smoothed

    @property
    def key(self) -> tuple:
        return (self.envelope, plan_key(self.plan), self.placement)

    def invalidate_executables(self) -> None:
        """Drop everything keyed to the old envelope (after a merge or
        replan): the cores (and the geometries they met), the warmed widths,
        the cached sentinel, and the resolved backend (the byte-model argmin
        may flip under the grown envelope)."""
        self.cores = None
        self.compiled_widths = set()
        self.sentinel = None
        self.backend = None


@dataclasses.dataclass
class ServiceStats:
    submitted: int = 0
    served: int = 0
    buckets_created: int = 0
    budget_merges: int = 0     # geometries folded into an existing bucket
    budget_overflows: int = 0  # no compatible bucket; budget exceeded anyway
    dominated_hits: int = 0    # requests absorbed by a larger existing bucket
    compiles: int = 0          # total batched-core traces across all buckets
    exec_s: float = 0.0        # total bucket execution wall time (warm only)
    compile_s: float = 0.0     # total cold-core wall time (sentinel warmups)
    padded_requests: int = 0   # padding slots executed (flush-tail waste)
    dominated_padding_bytes: int = 0  # staged-byte waste of dominated hits
    evictions: int = 0         # idle buckets dropped to admit a new geometry
    refaults: int = 0          # evicted geometries that came back (recompiled)
    shed: int = 0              # submits rejected by admission control
    admission_flushes: int = 0  # forced flushes to stay under max_pending
    slo_flushes: int = 0       # poll() flushes triggered by the latency SLO
    replans: int = 0           # buckets re-planned from observed latency
    learned_widths: int = 0    # ladder widths added from the tail distribution


class SpGEMMService:
    """Continuous-batching SpGEMM endpoint over ``chunked_spgemm_batched``.

    ``plan`` pins one ChunkPlan for every request (all requests must share its
    row geometry); without it, each request is planned by ``plan_knl`` against
    ``fast_limit_bytes``. ``quantum`` controls envelope quantization (bigger =
    fewer buckets, more padding waste), ``max_batch`` the largest microbatch
    width, ``retrace_budget`` the maximum number of distinct compiled buckets,
    and ``backend`` the executor every bucket runs: any registered spec with a
    batched entry (``backend_registry.batched_backends()``) or ``"auto"``,
    which resolves per bucket from the planner byte models. ``block_size``
    opts the block-level symbolic phase into every submit-time envelope
    (defaulted from the spec for block backends like ``"bsr"``; set it
    explicitly under ``"auto"`` to let buckets resolve to a block backend).
    ``device`` is where every flush runs: ``None`` is the card, and a CPU
    service (the kernels' plain versions) is asked for with ``"cpu"``.
    ``slow_reads`` is ``chunked_spgemm_batched``'s, for every flush:
    ``"ring"`` streams a bucket's slow operands through the copy ring,
    ``"in_place"`` has the streaming kernel read them where they lie (a
    backend without one raises here, ``auto`` at the flush that resolves to
    one).

    Serving knobs (all optional; defaults preserve the synchronous
    queue+flush behavior):

    * ``slo_s`` — per-request latency SLO: :meth:`poll` flushes a bucket
      whose oldest request has waited longer.
    * ``max_pending``/``admission`` — bound on total queued requests;
      ``"shed"`` raises :class:`AdmissionError`, ``"flush"`` drains the
      oldest-deadline bucket to make room.
    * ``eviction_hysteresis`` — enables cold-bucket eviction: with the
      budget full, a bucket that is idle (empty queue) and has not been
      touched for this many bucket-executions may be evicted to admit a new
      geometry. ``None`` (default) disables eviction (budget merges only).
    * ``donate_buffers`` — the reference's donation of the staged
      C-accumulator stacks into its jitted cores. The port stages them
      fresh every flush and its outputs are fresh allocations, so the flag
      changes nothing; it is kept (and handed to ``make_batched_cores``) so
      the API is the reference's.
    * ``learn_tail_widths`` — add a flush-tail size seen
      ``tail_learn_threshold`` times to the width ladder (one extra compile,
      zero padding for that tail thereafter).
    * ``adapt_quantum`` — per-(shapes, dtype, plan) families adapt their
      envelope quantum from observed traffic: churny families (mostly bucket
      misses) coarsen up to ``8 * quantum``, stable families (mostly hits)
      tighten down to ``quantum / 4``.
    """

    _ENV_MEMO_CAP = 256          # submit-path envelope memo entries (strong refs)
    _ADAPT_WINDOW = 16           # submits per family between quantum adjusts

    def __init__(self, plan: ChunkPlan | None = None, *,
                 fast_limit_bytes: float | None = None,
                 quantum: int = 32, max_batch: int = 4,
                 retrace_budget: int = 8, backend: str = "scan",
                 block_size: int | None = None,
                 slo_s: float | None = None,
                 max_pending: int | None = None,
                 admission: str = "shed",
                 eviction_hysteresis: int | None = None,
                 donate_buffers: bool = True,
                 learn_tail_widths: bool = False,
                 tail_learn_threshold: int = 3,
                 adapt_quantum: bool = False, device=None, slow_reads: str = "ring"):
        if plan is None and fast_limit_bytes is None:
            raise ValueError("need a fixed plan or fast_limit_bytes to plan by")
        if max_batch < 1 or quantum < 1 or retrace_budget < 1:
            raise ValueError("quantum, max_batch, retrace_budget must be >= 1")
        if admission not in ("shed", "flush"):
            raise ValueError("admission must be 'shed' or 'flush'")
        if max_pending is not None and max_pending < 1:
            raise ValueError("max_pending must be >= 1 (or None)")
        if eviction_hysteresis is not None and eviction_hysteresis < 0:
            raise ValueError("eviction_hysteresis must be >= 0 (or None)")
        spec = None if backend == "auto" else backend_registry.get(backend)
        if spec is not None and not spec.supports_batched:
            raise ValueError(
                f"backend {backend!r} does not support batched execution")
        if slow_reads not in SLOW_READS:
            raise ValueError(f"slow_reads must be one of {SLOW_READS}, not {slow_reads!r}")
        if slow_reads == "in_place" and spec is not None and spec.run_batched_in_place is None:
            raise in_place_refusal(f"backend {backend!r} has no such kernel")
        if block_size is None and spec is not None and spec.needs_block_caps:
            block_size = spec.block_size
        self.device = resolve_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self._plan = plan
        self._fast_limit = fast_limit_bytes
        self.quantum = quantum
        self.max_batch = max_batch
        self.retrace_budget = retrace_budget
        self.backend = backend
        self.slow_reads = slow_reads
        self.block_size = block_size
        self.slo_s = slo_s
        self.max_pending = max_pending
        self.admission = admission
        self.eviction_hysteresis = eviction_hysteresis
        self.donate_buffers = donate_buffers
        self.learn_tail_widths = learn_tail_widths
        self.tail_learn_threshold = tail_learn_threshold
        self.adapt_quantum = adapt_quantum
        # bounded microbatch width ladder: powers of two below max_batch plus
        # max_batch itself ({1, 2, 4, ..., max_batch}); learn_tail_widths may
        # insert observed tail sizes later
        self.widths = sorted(
            {1 << i for i in range(max_batch.bit_length())
             if (1 << i) < max_batch} | {max_batch}
        )
        self._buckets: dict = {}         # key -> _Bucket
        self._next_id = 0
        self._tick = 0                   # bucket-execution counter (LRU clock)
        self._evicted_keys: dict = {}    # bucket key -> eviction tick (bounded)
        self._ready: list = []           # responses produced outside poll/drain
        self._tail_counts: collections.Counter = collections.Counter()
        self._env_memo: collections.OrderedDict = collections.OrderedDict()
        self._family_quanta: dict = {}   # family -> adapted quantum
        self._family_traffic: dict = {}  # family -> [events, misses]
        self._plan_overrides: dict = {}  # plan_key -> replanned ChunkPlan
        self.stats = ServiceStats()

    # -- request path -------------------------------------------------------

    def _plan_for(self, A: CSR, B: CSR) -> ChunkPlan:
        plan = (self._plan if self._plan is not None
                else plan_knl(A, B, fast_limit_bytes=self._fast_limit))
        # follow latency-replan overrides (chained after repeated replans)
        seen: set = set()
        while True:
            key = plan_key(plan)
            override = self._plan_overrides.get(key)
            if override is None or key in seen:
                return plan
            seen.add(key)
            plan = override

    def _instance_env(self, A: CSR, B: CSR, plan: ChunkPlan) -> GeometryEnvelope:
        """Unquantized instance envelope, memoized by operand identity.

        ``instance_envelope`` runs the host-side symbolic expansion
        (``strip_output_caps``) — the dominant submit-path cost on warm
        traffic, which typically resubmits the *same* CSR objects. The memo
        is a bounded LRU keyed by ``(id(A), id(B), plan, block_size)`` with
        the operands themselves stored for an identity re-check (so a
        recycled ``id`` can never alias a stale envelope); the strong refs
        it holds are bounded by ``_ENV_MEMO_CAP``."""
        key = (id(A), id(B), plan_key(plan), self.block_size)
        hit = self._env_memo.get(key)
        if hit is not None and hit[0] is A and hit[1] is B:
            self._env_memo.move_to_end(key)
            return hit[2]
        env = instance_envelope(A, B, plan, block_size=self.block_size)
        self._env_memo[key] = (A, B, env)
        if len(self._env_memo) > self._ENV_MEMO_CAP:
            self._env_memo.popitem(last=False)
        return env

    def _family_quantum(self, family: tuple) -> int:
        if not self.adapt_quantum:
            return self.quantum
        return self._family_quanta.get(family, self.quantum)

    def _adapt_family(self, family: tuple, outcome: str) -> None:
        """Adapt a family's quantum from its observed hit/miss mix: mostly
        misses (new buckets, merges) means the geometry churns — coarsen so
        more of it collapses together; mostly hits means it is stable —
        tighten to shave padding. Bounded to [quantum/4, 8*quantum]."""
        if not self.adapt_quantum:
            return
        rec = self._family_traffic.setdefault(family, [0, 0])
        rec[0] += 1
        if outcome != "hit":
            rec[1] += 1
        if rec[0] < self._ADAPT_WINDOW:
            return
        events, misses = rec
        q = self._family_quanta.get(family, self.quantum)
        if misses * 2 > events:
            q = min(q * 2, self.quantum * 8)
        elif misses * 8 < events:
            q = max(q // 2, max(1, self.quantum // 4))
        self._family_quanta[family] = q
        self._family_traffic[family] = [0, 0]

    def _create_bucket(self, env: GeometryEnvelope, plan: ChunkPlan,
                       placement: Placement) -> _Bucket:
        bucket = _Bucket(envelope=env, plan=plan, queue=[], placement=placement,
                         last_used=self._tick)
        self._buckets[bucket.key] = bucket
        self.stats.buckets_created += 1
        if bucket.key in self._evicted_keys:
            del self._evicted_keys[bucket.key]
            self.stats.refaults += 1
        return bucket

    def _try_evict(self) -> bool:
        """Evict the least-recently-used idle bucket, if eviction is enabled
        and some bucket has been idle past the hysteresis. Returns whether a
        slot was freed. Only empty-queue buckets are candidates (evicting
        queued work would drop requests), and the hysteresis keeps a bucket
        that *just* flushed from bouncing out the moment a new geometry
        arrives."""
        if self.eviction_hysteresis is None:
            return False
        candidates = [
            b for b in self._buckets.values()
            if not b.queue
            and (self._tick - b.last_used) >= self.eviction_hysteresis
        ]
        if not candidates:
            return False
        victim = min(candidates, key=lambda b: b.last_used)
        del self._buckets[victim.key]
        # bounded evicted-key memory, oldest forgotten first: enough to
        # recognize refaults without growing with the geometry universe
        self._evicted_keys[victim.key] = self._tick
        cap = max(8 * self.retrace_budget, 64)
        while len(self._evicted_keys) > cap:
            self._evicted_keys.pop(next(iter(self._evicted_keys)))
        self.stats.evictions += 1
        return True

    def _resolve_bucket(self, env: GeometryEnvelope, plan: ChunkPlan,
                        placement: Placement) -> tuple:
        """Find or make the bucket serving ``env`` with operands where
        ``placement`` puts them (buckets of another placement never serve
        it); returns ``(bucket, outcome)`` with outcome in {"hit", "create",
        "merge", "overflow"} (feeding quantum adaptation)."""
        key = (env, plan_key(plan), placement)
        bucket = self._buckets.get(key)
        if bucket is not None:
            return bucket, "hit"
        # a bigger already-compiled bucket serves this geometry for free —
        # pick the *tightest* dominator (minimal staged padding), not the
        # first in dict order, and account the padding the hit still costs
        dominators = [
            b for b in self._buckets.values()
            if b.key[1:] == key[1:] and b.envelope.dominates(env)
        ]
        if dominators:
            best = min(dominators, key=lambda b: b.envelope.staged_nbytes())
            self.stats.dominated_hits += 1
            self.stats.dominated_padding_bytes += (
                best.envelope.staged_nbytes() - env.staged_nbytes())
            return best, "hit"
        if len(self._buckets) < self.retrace_budget or self._try_evict():
            return self._create_bucket(env, plan, placement), "create"
        # budget exhausted and nothing evictable: grow a compatible bucket's
        # envelope instead of compiling another program (its next flush
        # retraces once, then the merged geometry is stable)
        candidates = [
            b for b in self._buckets.values()
            if b.key[1:] == key[1:]
            and b.envelope.a_shape == env.a_shape
            and b.envelope.b_shape == env.b_shape
            and b.envelope.dtype == env.dtype
        ]
        if candidates:
            host = max(candidates, key=lambda b: b.served + len(b.queue))
            del self._buckets[host.key]
            host.envelope = host.envelope.union(env).quantized(self.quantum)
            host.invalidate_executables()
            other = self._buckets.get(host.key)
            if other is not None:
                # the grown envelope landed exactly on another bucket: fold
                # the host's queue into it rather than clobbering either
                other.queue.extend(host.queue)
                host = other
            else:
                self._buckets[host.key] = host
            self.stats.budget_merges += 1
            return host, "merge"
        # nothing compatible (different shapes/plan/placement): must exceed
        # the budget
        bucket = self._create_bucket(env, plan, placement)
        self.stats.budget_overflows += 1
        return bucket, "overflow"

    def _admit(self) -> None:
        if self.max_pending is None or self.pending < self.max_pending:
            return
        if self.admission == "shed":
            self.stats.shed += 1
            raise AdmissionError(
                f"{self.pending} requests pending >= max_pending="
                f"{self.max_pending} (admission='shed')")
        # admission == "flush": drain the oldest-deadline bucket to make
        # room; its responses surface through the futures and the next
        # poll/drain return
        queued = [b for b in self._buckets.values() if b.queue]
        oldest = min(queued, key=lambda b: b.queue[0].submit_s)
        self._ready.extend(self._execute_bucket(oldest))
        self.stats.admission_flushes += 1

    def submit(self, A: CSR, B: CSR, placement: Placement | None = None) -> SpGEMMFuture:
        """Queue one C = A x B request; returns its future (an ``int``
        subclass carrying the request id). Raises :class:`AdmissionError`
        when over ``max_pending`` with ``admission="shed"``.

        The request's placement is read from its operands on a card service
        (``placement.resolve_placement``: pinned is slow, on the card fast,
        C in A's space) and is ``placement`` (all fast by default) on a CPU
        one; an operand on neither the service's device nor, for a card
        service, in pinned host memory raises ``ValueError``."""
        where, _ = resolve_placement({"A": A, "B": B}, placement, self.device)
        for m in (A, B):
            if m.device.type == "cuda" and m.device != self.device:
                raise ValueError(f"SpGEMMService.submit: an operand is on {m.device}, "
                                 f"the service runs on {self.device}")
        self._admit()
        plan = self._plan_for(A, B)
        raw = self._instance_env(A, B, plan)
        family = (raw.a_shape, raw.b_shape, raw.dtype, plan_key(plan))
        env = raw.quantized(self._family_quantum(family))
        bucket, outcome = self._resolve_bucket(env, plan, where)
        self._adapt_family(family, outcome)
        future = SpGEMMFuture(self._next_id, self)
        req = SpGEMMRequest(self._next_id, A, B, time.perf_counter(),
                            future=future)
        self._next_id += 1
        bucket.queue.append(req)
        bucket.last_used = self._tick
        self.stats.submitted += 1
        return future

    @property
    def pending(self) -> int:
        return sum(len(b.queue) for b in self._buckets.values())

    @property
    def n_buckets(self) -> int:
        return len(self._buckets)

    def bucket_summaries(self) -> list:
        """(envelope, algorithm, compiles, executions, served, widths_used)
        per bucket."""
        return [
            (b.envelope, b.plan.algorithm, b.compiles, b.executions, b.served,
             frozenset(b.widths_used))
            for b in self._buckets.values()
        ]

    # -- execution path -----------------------------------------------------

    def _sentinel_pair(self, bucket: _Bucket) -> tuple:
        """Envelope-shaped empty (A, B) instances where the bucket's
        requests lie (``place`` on the service's device: the card or pinned
        host memory): the padding filler for flush tails and the warmup
        batch for cold cores. An empty instance is dominated by every
        envelope, stages to the envelope's exact shapes, and multiplies to
        nothing — so padded slots do no real multiply work."""
        if bucket.sentinel is None:
            env = bucket.envelope
            dtype = getattr(torch, env.dtype)

            def empty(shape: tuple, space: str) -> CSR:
                host = csr_from_scipy_like(
                    np.zeros(shape[0] + 1, np.int64), np.zeros(0, np.int64),
                    np.zeros(0, _NP_DTYPES[dtype]), shape, dtype=dtype, device="cpu")
                return place(host, space, self.device)

            bucket.sentinel = (empty(env.a_shape, bucket.placement.A),
                               empty(env.b_shape, bucket.placement.B))
        return bucket.sentinel

    def _resolve_backend(self, bucket: _Bucket) -> backend_registry.BackendSpec:
        if bucket.backend is None:
            # per-bucket resolution: the envelope is the geometry, so the
            # accumulator choice is stable across the bucket's lifetime
            # (until a budget merge grows the envelope — the merge
            # invalidates the resolution along with the executables)
            bucket.backend = (
                select_accumulator_backend(bucket.plan, bucket.envelope)
                if self.backend == "auto" else self.backend)
        spec = backend_registry.get(bucket.backend)
        if bucket.cores is None and spec.make_batched_cores is not None:
            # the bucket is the sole owner of its cores, so evicting it (or
            # invalidating after a merge) drops them with their geometries
            bucket.cores = spec.make_batched_cores(donate=self.donate_buffers)
        return spec

    def _run_batch(self, bucket: _Bucket, As: list, Bs: list) -> tuple:
        Cs, stats = chunked_spgemm_batched(
            As, Bs, bucket.plan, envelope=bucket.envelope,
            backend=bucket.backend, validate_caps=False, cores=bucket.cores,
            placement=bucket.placement, device=self.device, slow_reads=self.slow_reads,
        )
        # the card has finished when the timed span ends, not only issued
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return Cs, stats

    def _execute_bucket(self, bucket: _Bucket) -> list:
        """Drain one bucket in ladder-width microbatches; returns responses."""
        spec = self._resolve_backend(bucket)
        # the spec's trace-key template names the counters the compile
        # accounting below watches — no per-backend suffix table to maintain.
        # A flush moves only its own cores' counts: the plan's algorithm's,
        # or under a placed scan bucket the knl core its steps run on
        counters = {spec.trace_key_batched.format(alg=alg)
                    for alg in backend_registry.ALGORITHMS}
        responses = []
        while bucket.queue:
            batch = bucket.queue[: self.max_batch]
            del bucket.queue[: len(batch)]
            size = len(batch)
            # a recurring flush tail earns its own exact ladder width: one
            # extra compile, zero padding for that tail size thereafter
            if self.learn_tail_widths and size not in self.widths:
                self._tail_counts[size] += 1
                if self._tail_counts[size] >= self.tail_learn_threshold:
                    bisect.insort(self.widths, size)
                    self.stats.learned_widths += 1
            # pad to the smallest ladder width that fits, with envelope-
            # shaped empty sentinel instances (padded slots multiply nothing
            # and their outputs are never materialized into responses)
            width = next(w for w in self.widths if w >= size)
            if width > size:
                A0, B0 = self._sentinel_pair(bucket)
                As = [r.A for r in batch] + [A0] * (width - size)
                Bs = [r.B for r in batch] + [B0] * (width - size)
            else:
                As = [r.A for r in batch]
                Bs = [r.B for r in batch]
            bucket.widths_used.add(width)
            traces0 = sum(TRACE_COUNTS[c] for c in counters)
            # validate_caps=False throughout: every request's exact instance
            # envelope was computed at submit time and its bucket envelope
            # dominates it by construction (domination check, union growth,
            # quantize-only-up), so the batched path's per-instance symbolic
            # re-expansion would be pure overhead on the hot path
            compile_s = 0.0
            if width not in bucket.compiled_widths:
                # warm the core on an all-sentinel batch first, so the cold
                # start (and one envelope-shaped execution — compile_s is an
                # upper bound, not a pure-trace time) never pollutes the real
                # batch's exec_s/latency_s
                A0, B0 = self._sentinel_pair(bucket)
                t0 = time.perf_counter()
                self._run_batch(bucket, [A0] * width, [B0] * width)
                compile_s = time.perf_counter() - t0
                bucket.compiled_widths.add(width)
                self.stats.compile_s += compile_s
            t0 = time.perf_counter()
            Cs, stats = self._run_batch(bucket, As, Bs)
            t1 = time.perf_counter()
            exec_s = t1 - t0
            new_traces = sum(TRACE_COUNTS[c] for c in counters) - traces0
            bucket.compiles += new_traces
            bucket.executions += 1
            self._tick += 1
            bucket.last_used = self._tick
            ewma = exec_s / size
            bucket.exec_ewma = (ewma if bucket.exec_ewma is None
                                else 0.5 * bucket.exec_ewma + 0.5 * ewma)
            self.stats.compiles += new_traces
            self.stats.exec_s += exec_s
            self.stats.padded_requests += width - size
            for req, C in zip(batch, Cs[:size]):
                resp = SpGEMMResponse(
                    req_id=req.req_id, C=C,
                    latency_s=t1 - req.submit_s, exec_s=exec_s,
                    compile_s=compile_s,
                    bucket_key=bucket.key, batch_size=size,
                    padded_batch=width, stats=stats,
                )
                if req.future is not None:
                    req.future._response = resp
                responses.append(resp)
            bucket.served += size
            self.stats.served += size
        return responses

    def _take_ready(self) -> list:
        out, self._ready = self._ready, []
        return out

    def _due_buckets(self) -> list:
        """Buckets with something to run, oldest queued request first — the
        priority order every flush walks (oldest-deadline-first, not dict
        insertion order)."""
        queued = [b for b in self._buckets.values() if b.queue]
        return sorted(queued, key=lambda b: b.queue[0].submit_s)

    def poll(self) -> list:
        """Flush every *due* bucket: queue reached a full microbatch, or the
        oldest request has waited past ``slo_s``. Due buckets run
        oldest-deadline-first and responses return in execution order
        (plus any responses an admission flush produced since the last
        poll/drain)."""
        now = time.perf_counter()
        responses = self._take_ready()
        for bucket in self._due_buckets():
            if len(bucket.queue) >= self.max_batch:
                responses.extend(self._execute_bucket(bucket))
            elif (self.slo_s is not None
                    and now - bucket.queue[0].submit_s > self.slo_s):
                self.stats.slo_flushes += 1
                responses.extend(self._execute_bucket(bucket))
        return responses

    def drain(self) -> list:
        """Execute every queued request (oldest-deadline bucket first);
        responses ordered by request id."""
        responses = self._take_ready()
        for bucket in self._due_buckets():
            responses.extend(self._execute_bucket(bucket))
        responses.sort(key=lambda r: r.req_id)
        return responses

    def flush(self) -> list:
        """Synchronous alias of :meth:`drain` (the original queue+flush API)."""
        return self.drain()

    # -- feedback path ------------------------------------------------------

    def replan_lagging_buckets(self, slo_s: float | None = None) -> int:
        """Feed observed per-bucket latency back into planning: any bucket
        whose smoothed per-request execution time exceeds the SLO is
        re-planned with a coarser streamed-B partition
        (``planner.replan_for_latency`` — fewer, larger chunks, fewer kernel
        launches), its executables dropped, and its queued requests re-routed
        through the new plan (their envelopes are rebuilt: the chunk bounds
        changed). The override sticks: future submits that would have used
        the old plan get the replanned one. Returns the number of buckets
        re-planned."""
        slo = self.slo_s if slo_s is None else slo_s
        if slo is None:
            raise ValueError("replan_lagging_buckets needs slo_s (argument "
                             "or service-level)")
        replanned = 0
        for bucket in list(self._buckets.values()):
            if (bucket.exec_ewma is None or bucket.exec_ewma <= slo
                    or bucket.plan.n_b <= 1):
                continue
            new_plan = replan_for_latency(bucket.plan)
            if plan_key(new_plan) == plan_key(bucket.plan):
                continue
            self._plan_overrides[plan_key(bucket.plan)] = new_plan
            del self._buckets[bucket.key]
            self.stats.replans += 1
            replanned += 1
            for req in bucket.queue:
                raw = self._instance_env(req.A, req.B, new_plan)
                family = (raw.a_shape, raw.b_shape, raw.dtype,
                          plan_key(new_plan))
                env = raw.quantized(self._family_quantum(family))
                target, _ = self._resolve_bucket(env, new_plan, bucket.placement)
                target.queue.append(req)
        return replanned
