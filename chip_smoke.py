"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--objects N]

Phases (any failure raises and exits non-zero):

1. device: require CUDA, print the card's name and power limit, build the
   hand-written kernels from ``gatekeeper_tpu_torch/csrc/``;
2. kernels: hold every kernel bit for bit against its plain PyTorch
   version on numpy-seeded grids at the audit sweep's shape (C=44,
   N=32,768, k=20) and at edge shapes (hits on both sides of the cluster's
   segment edges, all hits in the last segment, k spanning segments, k past
   the hits, N=8, N=33, N=1,000, a misaligned view, rows of more than one
   pass, 70,000 rows), then time the kernel, the plain version, one
   ``torch.topk`` call (the library yardstick) and an empty kernel (the
   launch floor) on the device clock (see ``device_ms``);
3. path: the library audit sweep (all 46 templates of ``library/``, 44
   Rego and 2 CEL, each with its sample constraint; every template must
   lower to the device grid; ``--objects`` synthetic cluster objects,
   chunks of 32,768, 20 kept violations per constraint) through
   ``AuditManager.audit()`` on the card, once per collect lane: both lanes
   must agree, each fold kernel must have been launched by its lane, the
   rows of both CEL kinds must have ridden at least one of those launches
   and each CEL constraint must have violations, and a CPU run of the port
   (plain versions) must equal the card's run on the first 4,096 objects;
4. pipeline: the audit's host path, on the first 40,960 of the path
   phase's objects (``DEPTH_OBJECTS``, two chunks, cut from 131,072 and
   then 65,536 for the time limit; phases 6, 7, 8, 10 (b)-(c), 15 (c) and 17 run on them too, and
   their relist on both lanes, which must agree, stands for the path
   phase's run in every comparison of those phases), reduced lane: (a0) a dict lister on the default schedule (``auto``, which
   resolves to serial: the port's stages share the interpreter lock) and
   (a) that lister on the serial schedule, twice each in ABBA order; (b) a lister of
   ``RawJSON`` objects (serialized before the timer starts), serial,
   ``flatten_lane="raw"``; (c) that lister on the staged pipeline
   (``pipeline="on"``), raw lane, W flatten worker processes (W =
   min(4, effective cores - 2), at least 2); (d) on the first 4,096
   objects, ``pipeline="differential"`` with the ``RawJSON`` lister and W
   workers on both collect lanes; then (c)'s manager once more, warm,
   under ``torch.profiler``.  Every run must equal the path phase's run
   canonically ((d): its card run of the first 4,096 objects), (a0)'s
   walls may sum to at most 1.3 times (a)'s (the host's run-to-run
   noise), (d) must
   set ``pipeline_differential_ok``, (c) must run pipelined and (c) and
   (d) must not degrade to serial, both native columnizers must have
   built, no chunk of (b) or (c) may take a lane other than ``raw`` /
   ``raw+workers``, every chunk of (c) that the columnizer's thread clamp
   splits must have used the workers, the vocab must be a bijection after
   (c), both fold kernels must launch inside the pipelined sweeps
   (counted), and the profiled run must show device events and its
   host-to-device copies must not
   exceed one per dtype buffer and one for the mask per chunk, plus the
   counted misses of the table and parameter caches.  Prints each run's
   wall, objects/s, ``flatten``, ``c_columnize``, ``wire_pack``,
   ``upload``, ``h2d_bytes``, ``h2d_copies`` and ``fold_render``, the
   chunks per lane, the pipeline's per-stage busy/wait/stall and
   occupancy, ``device_wait_s`` and ``device_idle_fraction``, and
   ``os.cpu_count()`` and the effective core count.  Every relist run
   under the default schedule, in this and the path, profile, expand and
   extdata phases, must have run the schedule ``auto`` resolves to, and
   none may have degraded to serial;
5. shapes: at every distinct (C, N, k) that the path launched a kernel
   with, both kernels held bit for bit against their plain versions on an
   edge grid and on a random grid, then timed;
6. snapshot: the same objects and templates through the resident
   snapshot (``--audit-source snapshot``): per collect lane a
   ``FakeCluster``, a ``ClusterSnapshot``, a ``WatchIngester`` and
   ``DeviceResidency(mode="auto")`` on the card; (1) a first ``audit()``
   (builds, uploads, evaluates), (2) a second full ``audit()`` from
   resident columns only (repeated under ``torch.profiler`` for the
   device's idle share), (3) a clean ``audit_tick()``, (4) a 1% churn
   (label edits, ``privileged: true`` on some Pods, deletes and adds)
   pumped and ticked; on the reduced lane one more resident dispatch of a
   gathered chunk with ``return_bits=False``, which launches
   ``fused_fold``.  Every lowered group must be promoted, no resident
   chunk may take the host-column path, steps 1 and 2 must equal the path
   phase's relist run canonically, the repeat of step 2 must upload 0
   bytes, the dirty tick must evaluate only dirty rows and upload under 5%
   of the resident bytes, and the card must equal a CPU snapshot run
   (``mode="on"``) on the first 4,096 objects, step by step, where (5)
   ``audit_resync()`` runs after the churn tick and must find no
   difference on either device (the resync runs at that depth, not at the
   full one: at 131,072 objects it took ~44 s per lane).  Prints each
   step's wall, objects/s,
   snapshot-build (flatten), residency upload/patch and dispatch seconds,
   resident MB and uploaded bytes, and the rows patched;
7. expand: the same objects and templates with the mutation bench's 8
   mutators (6 the prefilter lowers, 2 host-only) and the reference's
   ``expand-deployments`` ExpansionTemplate, audited with
   ``--audit-expand``: every Deployment's implied Pod expands through the
   batched stage (mutated with ``Source=Generated``) and is audited on the
   card.  Relist on both collect lanes: the generated chunks must launch
   ``fused_fold`` (reduced) and ``epilogue`` (masks), counted inside the
   generator stage only; the implied Pods must add violations to the path
   phase's totals and no total may fall; both lanes must agree.  Then a
   resident-snapshot first pass, which must equal the relist canonically
   and hold ``[Implied by expand-deployments]`` violations in its
   generated verdicts, and a 1% churn tick.  The card must equal a CPU run
   on the first 4,096 objects.  Prints each pass's wall, generators,
   resultants, and the expand and generated-sweep seconds;
8. extdata: the library plus the reference docs' two image templates
   (``K8sExtData``, one ``external_data`` call over every container
   image, failing on ``response.errors``; ``K8sDigest``, one call per
   container, failing when the resolved digest differs), each with a
   constraint on v1 Pods, and two Provider manifests loaded by the CLI's
   ``build_extdata`` with the transport swapped for an in-process stub
   (``RegistryStub``: ``trusted`` errors outside ``openpolicyagent/``,
   ``digest`` pins; 1 ms per send; no network).  The relist of the path
   phase's objects with the batched lane on both collect lanes: the lanes
   must agree, both extdata kinds must ride the Pod group's fold launches
   (counted, with their (C, N)), their totals must equal a count made in
   Python from the objects and the stub's rule, the cold pass may send at
   most ceil(unique keys / 256) per provider per chunk (and each key
   once), and a warm repeat must send nothing.  At the first 4,096
   objects, the image templates alone with exact totals, the batched
   (grid), perkey (interpreter) and differential lanes on the card and
   the batched lane on the CPU must agree canonically; with the library,
   a resident snapshot's first pass must equal the batched relist, the
   residency logging its decline of the extdata group.  Then the
   first 512 admission bodies (``EXT_ADMISSIONS``, cut from 1,024 for the
   time limit) to ``/v1/admit`` and to ``/v1/mutate``
   (the ``pin-image`` Assign, failurePolicy Ignore), every answer equal
   to the CPU handler under the perkey lane.  Prints walls,
   ``perf["extdata"]`` seconds, sends and keys per provider (cold and
   warm), per-key against batched sends and seconds, and rates with
   p50/p99;
9. lifecycle: the served process's life, as ``python -m
   gatekeeper_tpu_torch --manifests library`` boots it (46 templates, 52
   constraints), with the first 512 admission bodies (64 clients; cut
   from 2,048 and then 1,024 for the time limit) and the path phase's
   objects (the
   first 16,384 of them for (b) and (d), cut from 131,072 and then
   65,536 and 32,768).  (a) generations under load: the CLI's
   serving stack on the card with ``generation_swap`` on, off, off, on
   (ABBA); while
   the bodies are posted a thread removes and re-adds five Rego templates
   one at a time and edits a sixth's message, through ``Client``; every
   answer must fit the CPU handler's under the old or the new set (per
   constraint: untouched ones as in both sets, the edited one as old or
   new, a churned one as old or absent while its template was out), a
   final burst of 256 after ``wait_idle`` must equal the new set exactly,
   and with the swap on at least one background swap must have happened
   with ``last_error`` None, no warm error, and every pre-swap warm's run
   of each program its build lowered returned.  (b) and (d) the snapshot: a first pass (step
   1) spilled in full (codec ``none``), loaded into a fresh driver and
   vocab (it must be a hit), then a warm tick (no row evaluated) and a
   resident pass (every adopted group uploaded whole, no patch) equal to
   the first pass; a 1% churn and a delta spill; a ``zlib`` spill loaded
   into another snapshot, equal; one flipped byte of a section, which must
   be a ``corrupt`` miss that deletes the spill, and a clean rebuild equal
   to the live snapshot; then a template removed with the coordinator
   running: the tick after the swap must re-chunk (no relist), the
   residency must have been evicted, and the tick must equal a fresh
   relist.  (c) a cold boot through ``CompileCache`` lowers every template;
   a fresh process booting from the same directory lowers none and gives
   the same ``query_batch`` verdicts on 1,024 objects.  (e) the CLI with
   ``--compile-cache`` and ``--webhook-workers W`` (W = min(4, effective
   cores // 2)), then W = 1: every answer equal to the CPU handler, every
   replica's CPU time (``/proc/PID/stat``) risen during the burst, and
   SIGTERM ending every process.  Prints each part's rates, p50/p99,
   compile and warm seconds per generation, spill bytes and seconds
   (capture on the audit thread, pickle and write on the worker), boot
   times, and the fold launches of (b) and (d);
10. hooks: the served process's hooks at full width (the CLI's library
   boot, 1,024 admission bodies, 64 clients, the pipeline phase's
   objects).
   (a) ``python -m gatekeeper_tpu_torch --manifests library --port P`` at
   the JAX CLI's defaults (the overload limiter, cost attribution, the SLO
   engine and the flight recorder on) and with them off (``HOOKS_OFF``),
   ABBA: every answer equal to the CPU handler's or of the JAX shed form
   (a code-429 deny with ``Retry-After``), no code 500, the request
   counters of ``/metrics`` summing to the answers, ``/debug/{cost,slo,
   overload,decisions}`` answering at the defaults and 404 with the hooks
   off, and the defaults' p99 sum at most 1.3 times hooks off's; prints
   rates, p50/p99, sheds, the grid batch sizes and the limiter's last
   limit.  (b) the relist on both lanes (of ``RawJSON`` objects on the
   raw flatten lane, for the time limit; after a warm-up) bare, under a
   keep-all tracer and cost attribution twice, bare (ABBA): equal
   verdicts, one ``device.sweep_dispatch`` span per dispatched chunk,
   every fold launch inside a dispatch span (or a collect span for an
   overflow's re-dispatch) of the Chrome trace, the attribution closing
   on the dispatch spans' wall within 5%, no more synchronizing calls
   (``torch.profiler``) than the bare relists, and per chunk and template
   the reduced lane's rows (the CUDA ``fused_fold``'s ``occ``) equal to
   the masks lane's host sums.  (c) a ``device.dispatch`` error once
   (verdicts equal, 1 retried) and twice past the retries (``INCOMPLETE``,
   the dropped chunk's totals the only difference), and a
   ``webhook.review`` hang under a 0.3 s deadline with failurePolicy
   Ignore (every answer allowed with the deadline warning within 1.3 s).
   (d) bursts against an 8-slot limiter and a 32-deep queue beside the
   audit loop over the first 32,768 objects (``HOOKS_BURST_OBJECTS``, cut
   from the path's width: the phase waits for the loop's pass in flight
   at its end): sheds with ``Retry-After``, no code 500, the brownout
   ladder at level 1 or more on ``/debug/overload``, and the audit's
   device-lane yield above 0 s (its counter in the metrics).  No hook may
   be left installed after a part;
11. kube: the served process over an apiserver, over the first 4,096 of
   the path phase's objects (``KUBE_OBJECTS``, cut from its width and then
   from 65,536, 32,768, 16,384 and 8,192 for the time limit).  The
   port's ``MockApiServer`` runs in a spawned child process that builds the same objects from the seed,
   the library's templates
   and sample constraints and a Config syncing Ingresses, with a resource
   for every constraint kind and per-pod status kind.  (a) a
   ``KubeCluster`` with raw pages and the CLI's discovery-driven lister
   (``__main__.kube_lister``) through ``AuditManager.audit()`` on both
   collect lanes: canonically equal to an in-memory dict relist of the
   same objects (run on the card just before the phase), every chunk on
   the raw lane, each lane's fold kernel launched; prints the wall,
   objects/s, LIST requests, page bytes and ``flatten`` /
   ``c_columnize`` / ``upload`` beside that dict relist's.  (b) a
   ``WatchIngester`` over a ``KubeCluster`` (residency ``auto``): step 1
   and a resident pass (both equal to the dict relist, every lowered
   group resident), a 1% churn written over HTTP (PUT, POST, DELETE) and
   its tick, equal to a fresh relist of the churned state.  (c) a spill,
   then a fresh ``KubeCluster`` and ingester resuming from the spill's
   versions: no LIST request of a data kind (counted on the mock), the
   first tick equal to (b)'s; prints load + first tick against (b)'s
   step 1 and
   the lifecycle phase's FakeCluster replay.  Then, on the resumed world,
   (b)'s end: 64 Pods dropped behind the watches, the watch cache
   compacted and every watch broken with a 410 (the relists' DELETED
   diff absorbed: the snapshot loses exactly those rows) and a resync that
   finds no difference.  (d) ``python -m gatekeeper_tpu_torch
   --kubeconfig K --audit-source snapshot --port 0 --emit-audit-events
   --emit-admission-events --export-dir D`` (the JAX defaults otherwise),
   started right after the hooks phase's (a) over a second such child
   (its boot and its first audit pass, at the JAX defaults' exact totals,
   run beside the rest of the hooks phase and the kube phase's (a)-(c),
   and no ABBA pair of an earlier phase runs beside them; the first child
   sees none of its writes): ``/healthz`` 503 until the readiness tracker is satisfied,
   then 200, both with its stats, and latched; the first audit pass
   exported; 512 admission bodies (``KUBE_BODIES``, cut from 1,024 for
   the time limit) from 64 clients, every answer equal
   to the CPU handler's (computed as ``_held_against_cpu`` does, over the
   CLI's apiserver's Namespaces and Ingresses, in a third child process
   beside the 410 step) or of the JAX shed form (the overload limiter is
   on), the shed bodies posted again by 8 clients until every body has a
   reviewed answer, each equal to the CPU handler's; a constraint written
   to the apiserver turns a later answer into a deny (then it is deleted
   again, so the audit loop has nothing to re-evaluate at the drain); the
   template's ``ConstraintTemplatePodStatus``, audit and admission Events
   on the apiserver; the export directory holds the audit's violations;
   SIGTERM drains and exits 0;
12. gator: the offline enforcement point through its entry point,
   ``gatekeeper_tpu_torch.gator.cli.main`` in this process (stdout
   captured, fold launches counted over the card's runs), with the
   library's 46 templates and sample constraints: ``verify library`` as a
   child process (``python -m gatekeeper_tpu_torch.gator``; 46 suites
   ok, exit 0), ``test -f library -o json`` twice (equal, exit 1);
   ``bench --engine sweep -n 1`` over the first 4,096 of the path
   phase's objects (``GATOR_OBJECTS``, cut from 8,192 for the time limit)
   at the audit's defaults (chunks of 500, exact totals) on the masks
   lane, which must launch ``epilogue``, and on the reduced lane (a
   child process): both equal to an ``AuditManager`` with exact totals
   on the card (a child process), whose run over the first 4,096 objects
   must equal a ``--device cpu`` sweep engine's (a child process);
   ``bench --engine tpu`` and ``--engine mutate`` (the expand phase's
   mutators) ``-n 3`` over 4,096 objects (``GATOR_REVIEW_OBJECTS``) on
   the card, equal to ``--device cpu`` runs (all four child processes;
   the host's exact-totals render bounds each run, so they overlap);
   ``expand --lane differential`` over the sweep objects' Deployments;
   512 admission bodies (cut from 1,024 for the time limit)
   (``GATOR_BODIES``) answered by a ``ValidationHandler`` on the card
   (a ``Batcher`` on the grid lane, 64 threads) with a capture-mode
   flight recorder, then ``replay --differential --compile-cache``
   (bit-identical, no divergence, no lowering missed the cache), a
   candidate without one deny-firing constraint (every divergence
   ``newly_allowed`` and attributed to it), ``decisions`` and ``triage
   -f`` over the sink (exit 0), and ``replay --from-spill
   --differential`` (a child process) over a spill of the sweep objects'
   snapshot (bit-identical).  Prints each step's wall, the sweep engine's
   reviews/s and p50/p99, the tpu and mutate engines' rates and replay's
   decisions/s;
13. canary: fleet mode, the shadow canary and the chaos soak.  (a) the
   first 8,192 of the path phase's objects split by a seeded draw into 32
   clusters of 64-512 objects, 24 on the library and 8 on the library
   less 4 templates, behind ``fleet.FleetEvaluator`` at its defaults
   (chunks of 500, exact totals, ``pack_chunks=0``) on the card, the two
   runtimes built by the ``--fleet-config`` CLI's factory over one disk
   compile cache: every cluster's totals and kept lists must equal an
   ``AuditManager`` sweep of that cluster alone on the card (a child
   process), which must dispatch at least 2x as often as the packed pass;
   every cluster after a library's first must boot with 0 fresh
   lowerings; a spill of every cluster, a stop and a warm restart must
   evaluate no row and give the same verdicts; the first 4 clusters must
   equal a ``--device cpu`` fleet (a child process), and ``python -m
   gatekeeper_tpu_torch --fleet-config ROSTER --once`` over them (a child
   process on the card) must exit 0 with the same per-cluster totals.
   (b) 512 admission bodies (``CANARY_BODIES``, cut from 1,024 for the
   time limit) posted by 64 keep-alive clients to
   ``WebhookServer`` on the card (the grid lane, a capture-mode flight
   recorder) with a ``replay/shadow.ShadowLane`` over a candidate that
   carries the constraint denying most bodies alone at ``enforcementAction:
   dryrun``: every answer must equal the CPU handler's; after the drain
   ``evaluated`` must equal the answers served, ``lane_errors``,
   ``dropped`` and ``skipped`` be 0, ``/debug/shadow`` answer the JAX
   package's keys, the divergences be ``would_allow`` (and ``message``
   where another constraint denies too) and equal ``gator replay`` of the
   capture against the same candidate, which attributes every removal to
   that constraint; ``POST /debug/shadow`` promote must apply the
   candidate, after which the bodies it allowed are allowed.  (c)
   ``fuzz.soak.run_soak`` on the card (chaos on, the resident lane, once
   serially and once concurrently; the mutation and extdata seeded bugs
   on their families): the clean runs ``ok`` with no divergence, crash or
   lost verdict and ``resident_uploads`` above 0, each seeded bug caught
   by its lane, and in every run ``collect_differential_ok`` equal to the
   chunks dispatched through both fold kernels.  Both kernels must launch
   in the phase (counted in process);
14. sidecar: the Evaluate sidecar (``rpc/sidecar.py``) and its control
   plane client (``drivers/remote.py``) on ``device``, through the
   loopback transport (``rpc.sidecar.Loopback``: the request and response
   bytes a gRPC frame would carry, through the hand-written codec, so the
   phase needs no ``grpc``).  (a) an ``EvaluateServicer`` on the card;
   the control plane's ``Client`` over a ``RemoteDriver`` (beside a
   ``CELDriver``, as ``--evaluate-sidecar`` builds them) reconciles the
   46 templates, their sample constraints and the path phase's Ingresses;
   Status must say ``gpu``, 1 device, 46 lowered, none on fallback.  (b)
   the control plane's ``AuditManager`` over ``RemoteEvaluator`` (reduced
   lane, 20 kept) on the path phase's objects in chunks of 32,768, one
   Sweep RPC each: totals and kept lists equal to the path phase's
   reduced-lane run canonically, ``fused_fold`` launched.  (c) the same at
   exact totals over the first 4,096 objects, equal to a CPU servicer's
   (``device="cpu"``, plain kernel versions; a child process started with
   the phase) run, kept lists in order.  (d) 512 admission
   bodies in batches of 64 through ``RemoteDriver.query_batch``, every
   answer equal to the servicer's ``TorchDriver`` called in process.  (e)
   four threads sweep four 8,192-object chunks at once: each result equal
   to its serial sweep, and some sweep's submit (the servicer's lock held)
   overlapping another's collect (the lock released).  Prints each Sweep
   RPC's wall and bytes, the codec's encode and decode seconds, the
   seam's objects/s beside the path phase's, and whether ``grpc`` and
   ``google.protobuf`` import on the host;
15. mesh (multi-device / multi-process): the sweep's object axis split
   over a device mesh (``parallel/mesh.py``), each shard folded by the
   same hand-written kernels and the shards merged lowest index first on
   the host.  (a) a mesh of two shards on ``cuda:0`` (and one over every
   card when the host has more than one) with ``shard_chunks=2`` over
   the path phase's objects on the reduced lane, chunks of 32,768 a
   shard: totals, kept lists in order and messages equal to the path
   phase's run (beside (b)'s processes); every shard folds every
   dispatched chunk (``fused_fold``,
   or ``epilogue`` where an overflow re-dispatches it), counted per
   shard, and no ``torch.topk`` runs; then exact totals on the first
   1,024 objects (``MESH_EXACT_OBJECTS``: the host's render bounds it)
   over the mesh and on one device, equal in order.  (b) three ``python
   -m gatekeeper_tpu_torch --once --shard-chunks 2`` processes over the
   library and the first 4,096 objects (with a Config syncing Ingresses):
   ranks 0 and 1 of ``--coordinator 127.0.0.1:P --num-processes 2``, both
   on ``cuda:0`` (a 2-shard mesh whose results meet in one gloo gather per
   chunk), and one process alone; both ranks must print the
   ``joined global mesh`` line and the alone process's summary byte for
   byte.  Prints each rank's wall and its gathers' share of it; each has
   a timeout, and all three are killed if one fails.  (c) the wire
   narrowing: ``warm_pass`` over the first 40,960 objects, then their
   reduced-lane relist with the corpus stats and without (both beside
   (b)), equal to the depth relist in order, with fewer wire bytes;
   prints ``wire_bytes``, ``h2d_bytes``, ``upload`` and ``wire_pack``
   of both and of the depth relist (no gate on speed);
16. shapes (after the pipeline, snapshot, expand, extdata, lifecycle,
   hooks, kube, gator, canary, sidecar and mesh phases): as phase 5, at
   the (C, N, k) the pipeline, snapshot, expand, extdata, lifecycle,
   hooks, kube, gator, canary, sidecar and mesh paths launched too;
17. profile: the reduced-lane audit of the pipeline phase's objects once
   more under ``torch.profiler``,
   for the device's busy share of the audit wall and its top kernels;
18. admission: the library (all 46 templates and their sample
   constraints, the Ingresses of the traffic synced as inventory) served
   by the port's
   ``WebhookServer`` on 127.0.0.1 with ``TorchDriver(device="cuda")``, a
   ``Batcher`` at its default window, batch size and interpreter cut-off
   (with batch stats on), failurePolicy=Fail and the
   ``ExpansionSystem`` of the expand phase (each Deployment body's implied
   Pod reviewed with ``Source=Generated``).  512 (``ADMISSION_BODIES``,
   cut from 4,096, 2,048 and then 1,024 for the time limit; fewer when
   ``--admissions`` says so) AdmissionReview bodies (the library's
   ``samples/example_*.yaml``
   objects, then ``make_cluster_objects(..., seed=3)``; every tenth an
   UPDATE that carries an ``oldObject``, every twentieth of the others a
   DELETE whose ``object`` is null and whose ``oldObject`` is the object)
   are posted by 64 keep-alive clients in 8 load processes.  Every
   response must equal the port's in-process handler on the CPU without a
   batcher (the exact engines: the CEL evaluator and the Rego
   interpreter) and with the same expansion system, and some must carry
   ``[Implied by expand-deployments]`` lines; the deny message is compared as its set of lines, since
   that handler lists CEL results before Rego ones and the grid lane
   lists them by constraint kind, as in the JAX package.  No answer may
   have code 500, the grid lane must have run, the CEL DELETE route of
   ``query_batch`` must have run on the card, CEL constraints must have
   hit in grid batches and ``query_batch`` must not have raised.  Prints
   admissions/s, p50/p99 latency, the batch-size histogram, the lane
   counts, the DELETE count, the CEL hits per grid batch and the medians
   of the grid batches' ``flattenNS``/``batchEvalNS``/``totalNS``;
19. served: the served process's two threads on one driver and vocab, as
   ``python -m gatekeeper_tpu_torch --audit-source snapshot --port ...``
   runs them (``__main__.build_audit`` and ``start_audit_loop``): the
   webhook answers up to 512 of the admission bodies (cut from 1,024 so
   the whole run stays well inside its time limit) while the snapshot
   audit loop ticks and resyncs over a ``FakeCluster`` of 4,096 objects
   that churns meanwhile.  Every answer must equal the CPU handler, at
   least one tick and one resync must overlap the burst, no resync may
   take an admission's new strings for its own, a final resync must find
   no difference, the vocab must stay a bijection, every lowered group
   must be resident and no chunk may take the host-column path;
20. mutate: the admission bodies posted to ``/v1/mutate`` of a
   ``WebhookServer`` on the card (the batched ``MutationLane`` behind a
   ``MutationBatcher``, the bench's 8 mutators) by 64 keep-alive clients in
   8 processes.  Every answer must equal the per-object
   ``MutationHandler`` on the CPU, patch bytes included.  Then
   ``MutationSystem.mutate_batch`` over the same objects on the card (the
   6 lowered mutators, so the grids decide) must equal per-object
   ``mutate``, with rows decided by the compiled program.  Prints
   mutations/s, p50/p99, the outcome-lane histogram and the relevance
   rows' wall time through ``CompiledProgram.run`` on the card against the
   host ``_np_eval`` at bursts of 64 and 4,096, and one burst of each size
   through ``MutationLane`` under each ingest lane (``dict``, ``raw``,
   ``differential``), whose outcomes must be equal.  (``/v1/admit`` with
   the expansion system is served and held in the admission phase);
21. report: a ``{"kernels": [...]}`` line, then ``{"ok": true, ...}``
   last.
   ``launches`` counts the relist path's launches, ``pipeline_launches``
   those inside the pipeline phase's pipelined sweeps, ``snapshot_launches``
   the snapshot path's, ``expand_launches`` those inside the generator
   stage of the expand phase, ``extdata_launches`` those of the extdata
   phase's cold relist (the reduced lane's ``fused_fold``, the masks
   lane's ``epilogue``), ``lifecycle_launches`` those of the lifecycle
   phase (its snapshot passes' ``epilogue``, the relist's ``fused_fold``),
   ``hooks_launches`` those of the hooks phase (its relists, chaos relists
   and brownout audit loop; the CLI processes of (a) are not counted),
   ``kube_launches`` those of the kube phase's (a)-(c) (the CLI process
   of (d) is not counted), ``gator_launches`` those of the gator phase's
   runs on the card (not its references), ``canary_launches`` those of the
   canary phase's in-process fleet passes, replay and soak runs (not its
   child processes), ``sidecar_launches`` those of the sidecar phase's
   card servicer, (b)-(e), ``mesh_launches`` those of the mesh phase's
   in-process sweeps, (a) and (c) (not (b)'s processes).
   The served and lifecycle (e) phases pass ``HOOKS_OFF`` to the CLI: the
   configuration they measured before the CLI had the hooks.

Imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import collections
import copy
import gc
import http.client
import json
import os
import re
import statistics
import threading
import subprocess
import sys
import time
import zlib

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
INT8_OPS_PER_S = 1.979e15  # H100 SXM dense int8 tensor rate (data sheet)
# the library's two CEL (K8sNativeValidation) templates
CEL_TEMPLATE_KINDS = ("K8sContainerLimitsCEL", "K8sNoPrivileged")
C_MAIN, N_MAIN, K_MAIN = 44, 32768, 20
CPU_PREFIX = 4096  # cut from 8,192 for the time limit
CHURN_SHARE = 0.01  # of the objects, per dirty tick of the snapshot phase
GRAPH_CALLS = 20    # back-to-back calls captured in one CUDA graph
GRAPH_REPLAYS = 25  # timed replays of that graph (median taken)
LOAD_PROCS, LOAD_CONNS = 8, 8  # 64 keep-alive clients in 8 processes
SERVED_ADMISSIONS, SERVED_OBJECTS = 512, 4096  # the served phase's sizes
ADMISSION_BODIES = 512  # the admission phase's bodies (cut from 1,024)
# the CLI's hook flags off: the configuration the served and lifecycle
# phases measured before the CLI had the hooks
HOOKS_OFF = ("--overload-limiter", "off", "--cost-attribution", "off",
             "--slo", "off", "--flight-recorder", "0")


def log(msg: str) -> None:
    print(msg, flush=True)


def device_phase() -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    from gatekeeper_tpu_torch.ops import cuda_build

    t0 = time.perf_counter()
    paths = cuda_build.build()
    log(f"build: {time.perf_counter() - t0:.3f}s {sorted(paths)}")
    for name, out in sorted(cuda_build.reports.items()):
        log(f"nvcc {name}.cu:\n{out.strip()}")
    return {"card": card}


def call_ms(fn, reps: int = 50) -> float:
    """Median of CUDA-event pairs around ONE call each: the device clock,
    but the window holds the host's enqueue of the call too."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_ms(fn) -> float:
    """Device ms per call of ``fn``: CUDA events around replays of a CUDA
    graph that holds GRAPH_CALLS back-to-back calls, so no host work (the
    wrapper's checks, allocations, the ctypes call) falls inside the timed
    window.  Median over GRAPH_REPLAYS replays.  The inputs stay in the
    50 MB L2 from call to call, as the path's freshly written grids do."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(GRAPH_CALLS):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(GRAPH_REPLAYS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / GRAPH_CALLS)
    del graph
    return statistics.median(times)


def _max_abs_err(got, want) -> float:
    err = 0.0
    for g, w in zip(got, want):
        if not torch.equal(g, w):
            raise AssertionError(
                f"kernel disagrees with its plain version: {g} vs {w}")
        err = max(err, float((g.to(torch.int64) - w.to(torch.int64))
                             .abs().max().item()) if g.numel() else 0.0)
    return err


def edge_rows(c: int, n: int, seg: int, rng) -> np.ndarray:
    """A [c, n] grid whose rows cycle through the cases of the segment
    split: hits on both sides of every segment edge (and at 0, n-1), hits
    only in the last segment, one hit per segment, an empty row, a full
    row, and a sparse random row."""
    g = np.zeros((c, n), bool)
    edges = np.arange(seg, n, seg)
    last = ((n - 1) // seg) * seg
    for r in range(c):
        case = r % 6
        if case == 0:
            g[r, np.concatenate([edges - 1, edges, [0, n - 1]])] = True
        elif case == 1:
            g[r, last:] = rng.random(n - last) < 0.3
        elif case == 2:
            starts = np.arange(0, n, seg)
            span = np.minimum(starts + seg, n) - starts
            g[r, starts + (rng.random(starts.size) * span).astype(int)] = True
        elif case == 4:
            g[r] = True
        elif case == 5:
            g[r] = rng.random(n) < 0.002
    return g


def _misaligned(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``t`` whose data starts one byte past an
    aligned address (a view with a storage offset)."""
    buf = torch.zeros(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    assert view.is_contiguous() and view.data_ptr() % 16 != 0
    return view


def _cases(fold, rng) -> list:
    """(label, grid, mask, k) on the card."""
    cases = []

    def add(label, g, k, mask_density=0.7, edge=False):
        m = rng.random(g.shape) < mask_density
        if edge:
            m |= g  # keep the edge hits in scope for the fused kernel
        cases.append((label, torch.from_numpy(g).cuda(),
                      torch.from_numpy(m).cuda(), k))

    for d in (0.5, 0.001, 0.0):
        add(f"random density={d}", rng.random((C_MAIN, N_MAIN)) < d, K_MAIN)
    for c in (1, 45):
        add("random density=0.01", rng.random((c, N_MAIN)) < 0.01, K_MAIN)
    for k in (1, 126, 127, 128, 200):
        add("random density=0.05", rng.random((C_MAIN, 4096)) < 0.05, k)
    add("random density=0.05", rng.random((7, 1000)) < 0.05, K_MAIN)
    add("random density=0.5", rng.random((3, 33)) < 0.5, 40)
    add("random density=0.5", rng.random((6, 8)) < 0.5, K_MAIN)
    add("random density=0.3", rng.random((70000, 16)) < 0.3, 4)
    seg = fold.THREADS * fold.CHUNK
    for c, n, ks in ((16, N_MAIN, (3, 20, 200)), (3, 8192, (20,)),
                     (6, 16384, (20,)), (12, 65536, (20,)),
                     (12, 262144, (20, 40)), (6, 200003, (20,)),
                     (6, 1000, (20,))):
        for k in ks:
            add("segment edges", edge_rows(c, n, seg, rng), k, edge=True)
    for c, n in ((C_MAIN, N_MAIN), (6, 4096)):
        g = torch.from_numpy(edge_rows(c, n, seg, rng)).cuda()
        m = torch.from_numpy(rng.random((c, n)) < 0.7).cuda() | g
        cases.append(("misaligned view", _misaligned(g), _misaligned(m),
                      K_MAIN))
    return cases


def _bound(c: int, n: int, k: int, fused: bool) -> tuple:
    """(bound_ms, bound_by, bytes): the least time of the card for one
    fold: each input byte read once and each output byte written once over
    the HBM rate, against one AND, one compare and one count per input cell
    at the int8 peak."""
    out = c * k * 4 + c * k + c * 4 + (c * 4 if fused else 0)
    nbytes = (2 if fused else 1) * c * n + out
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = 3 * c * n / INT8_OPS_PER_S * 1e3
    if bytes_ms >= ops_ms:
        return bytes_ms, "bytes", nbytes
    return ops_ms, "operations", nbytes


def _check_both(fold, err, label, grid, mask, k) -> None:
    """Hold both kernels bit for bit against their plain versions on one
    case; keep the largest error of each in ``err``."""
    c, n = grid.shape
    err["fused_fold"] = max(err["fused_fold"], _max_abs_err(
        fold.fused_fold(grid, mask, k),
        fold.fused_fold_plain(grid, mask, k)))
    masked = grid & mask
    if grid.data_ptr() % 16:
        masked = _misaligned(masked)
    err["epilogue"] = max(err["epilogue"], _max_abs_err(
        fold.epilogue(masked, k), fold.epilogue_plain(masked, k)))
    torch.cuda.synchronize()
    plan = fold.fold_plan(n, grid.data_ptr() % 16 == 0)
    log(f"kernels agree: {label} C={c} N={n} k={k} plan={plan}")


def kernel_phase() -> tuple:
    from gatekeeper_tpu_torch.ops import fold

    rng = np.random.default_rng(0)
    err = {"fused_fold": 0.0, "epilogue": 0.0}
    for label, grid, mask, k in _cases(fold, rng):
        _check_both(fold, err, label, grid, mask, k)

    # timing at the sweep's shape: a sparse raw grid under a 70% mask
    c, n, k = C_MAIN, N_MAIN, K_MAIN
    grid = torch.from_numpy(rng.random((c, n)) < 0.01).cuda()
    mask = torch.from_numpy(rng.random((c, n)) < 0.7).cuda()
    masked = grid & mask
    idxs = torch.arange(n, dtype=torch.int32, device="cuda")
    score = torch.where(masked, n - idxs, 0).to(torch.int32)
    library_ms = device_ms(lambda: torch.topk(score, k, dim=1))
    floor_ms = device_ms(lambda: fold.empty_launch("cuda"))
    rows = []
    for name, line, fn, plain, fused in (
            ("fused_fold", 113, lambda: fold.fused_fold(grid, mask, k),
             lambda: fold.fused_fold_plain(grid, mask, k), True),
            ("epilogue", 33, lambda: fold.epilogue(masked, k),
             lambda: fold.epilogue_plain(masked, k), False)):
        bound_ms, bound_by, nbytes = _bound(c, n, k, fused)
        row = {
            "name": name, "route": "cuda",
            "source": "gatekeeper_tpu_torch/csrc/fold.cu",
            "replaces": f"gatekeeper_tpu/ops/pallas_topk.py:{line}",
            "max_abs_err": err[name],
            "ms": device_ms(fn), "plain_ms": device_ms(plain),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms,
            "call_ms": call_ms(fn), "floor_ms": floor_ms,
        }
        log(f"{name}: kernel {row['ms']:.5f} ms (device, graph replay), "
            f"{row['call_ms']:.5f} ms (one call), plain "
            f"{row['plain_ms']:.5f} ms, torch.topk {library_ms:.5f} ms, "
            f"floor {floor_ms:.5f} ms, bound {bound_ms:.6f} ms ({nbytes} "
            f"bytes) at C={c} N={n} k={k}")
        rows.append(row)
    return rows, err


def shape_phase(rows, err, shapes) -> None:
    """At every distinct (C, N, k) the path launched a kernel with: hold
    both kernels against their plain versions on an edge grid (under a 70%
    mask that keeps the edge hits in scope) and on a grid of density 0.01
    under a 70% mask, then time the kernel on the latter."""
    from gatekeeper_tpu_torch.ops import fold

    rng = np.random.default_rng(1)
    seg = fold.THREADS * fold.CHUNK
    for row in rows:
        name = row["name"]
        row["shapes"] = []
        for (c, n, k), launches in sorted(shapes[name].items()):
            edge = torch.from_numpy(edge_rows(c, n, seg, rng)).cuda()
            mask = torch.from_numpy(rng.random((c, n)) < 0.7).cuda()
            _check_both(fold, err, "path shape, segment edges", edge,
                        mask | edge, k)
            grid = torch.from_numpy(rng.random((c, n)) < 0.01).cuda()
            _check_both(fold, err, "path shape, density=0.01", grid, mask, k)
            masked = grid & mask
            if name == "fused_fold":
                ms = device_ms(lambda: fold.fused_fold(grid, mask, k))
            else:
                ms = device_ms(lambda: fold.epilogue(masked, k))
            bound_ms = _bound(c, n, k, name == "fused_fold")[0]
            row["shapes"].append({"c": c, "n": n, "k": k,
                                  "launches": launches, "ms": ms,
                                  "bound_ms": bound_ms})
            log(f"{name} at C={c} N={n} k={k}: {ms:.5f} ms (device), "
                f"{launches} launches on the main paths, plan "
                f"{fold.fold_plan(n, True)}")
    for row in rows:
        row["max_abs_err"] = err[row["name"]]


def _client(objects, device: str = "cuda", extdata: bool = False,
            library: bool = True, generation_swap: bool = False):
    """(client, driver, templates, constraints) as the CLI builds them:
    a ``TorchDriver`` with a ``CELDriver`` beside it, the whole library
    loaded (unless ``library`` is False), every template lowered; with
    ``extdata`` also the two image templates of the extdata phase, each
    with its constraint on v1 Pods; with ``generation_swap`` the driver's
    (not yet started) generation coordinator."""
    from gatekeeper_tpu_torch.apis.constraints import AUDIT_EP, WEBHOOK_EP
    from gatekeeper_tpu_torch.client.client import Client
    from gatekeeper_tpu_torch.drivers.cel_driver import CELDriver
    from gatekeeper_tpu_torch.drivers.torch_driver import TorchDriver
    from gatekeeper_tpu_torch.target.target import K8sValidationTarget
    from gatekeeper_tpu_torch.utils.synthetic import load_library

    cel = CELDriver()
    driver = TorchDriver(device=device, cel_driver=cel,
                         generation_swap=generation_swap)
    client = Client(target=K8sValidationTarget(), drivers=[driver, cel],
                    enforcement_points=[WEBHOOK_EP, AUDIT_EP])
    if driver.gen_coord is not None:
        driver.gen_coord.constraints_fn = client.constraints
    nt, nc = load_library(client) if library else (0, 0)
    if extdata:
        for kind, rules in EXT_TEMPLATES:
            client.add_template(_ext_template(kind, rules))
        for con in EXT_CONSTRAINTS:
            client.add_constraint(copy.deepcopy(con))
        nt, nc = nt + len(EXT_TEMPLATES), nc + len(EXT_CONSTRAINTS)
        if not set(EXT_KINDS) <= set(driver.lowered_kinds()):
            raise AssertionError("extdata templates did not lower")
    if driver.fallback_kinds():
        raise AssertionError(
            f"templates fell back to the interpreter: "
            f"{driver.fallback_kinds()}")
    if library and driver._cel_kinds != set(CEL_TEMPLATE_KINDS):
        raise AssertionError(f"CEL kinds {sorted(driver._cel_kinds)}")
    for o in objects:
        if o.get("kind") == "Ingress":
            client.add_data(o)  # referential inventory (uniqueingresshost)
    return client, driver, nt, nc


def _schedule_held(label: str, perf: dict) -> None:
    """A relist under the default schedule (``pipeline="auto"``) ran the
    schedule that ``auto`` resolves to, and no pipelined pass failed: the
    manager reruns a failed pipelined pass serially and only counts it in
    ``degraded_to_serial``, so without this check a fault would pass."""
    from gatekeeper_tpu_torch.pipeline import resolve_schedule

    want = 1.0 if resolve_schedule("auto", True) == "pipelined" else 0.0
    if perf.get("pipelined", 0.0) != want or perf.get("degraded_to_serial"):
        raise AssertionError(
            f"{label}: schedule {perf.get('pipelined')} where auto resolves "
            f"to {want}, degraded_to_serial "
            f"{perf.get('degraded_to_serial')}")


def audit(objects, device: str, collect: str, dispatches=None) -> tuple:
    """One library audit through the port's entry points: (run, phases,
    seconds).  ``dispatches`` (a list) receives (kinds, C, padded N) of
    every device dispatch of the sweep; each launches one fold kernel."""
    from gatekeeper_tpu_torch.audit.manager import AuditConfig, AuditManager
    from gatekeeper_tpu_torch.parallel.sweep import SweepEvaluator

    client, driver, _nt, _nc = _client(objects, device=device)
    evaluator = SweepEvaluator(driver, device=device, violations_limit=20,
                               collect=collect)
    if dispatches is not None:
        dispatch = evaluator.sweep_dispatch

        def recorded_dispatch(flat):
            if getattr(flat, "kinds", None):
                dispatches.append((flat.kinds, sum(
                    len(flat.by_kind[k]) for k in flat.kinds), flat.pad_n))
            return dispatch(flat)

        evaluator.sweep_dispatch = recorded_dispatch
    mgr = AuditManager(client, lister=lambda: iter(objects),
                       config=AuditConfig(violations_limit=20,
                                          chunk_size=32768,
                                          exact_totals=False,
                                          submit_window=4),
                       evaluator=evaluator)
    t0 = time.perf_counter()
    run = mgr.audit()
    if device == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    phases = {**evaluator.perf, **mgr.perf}
    _schedule_held(f"audit[{collect}]", mgr.perf)
    return run, phases, dt


def summary(run) -> tuple:
    kept = {key: [(v.constraint.kind, v.kind,
                   f"{v.namespace}/{v.name}", v.message) for v in vs]
            for key, vs in run.kept.items()}
    return run.total_objects, dict(run.total_violations), kept


def path_phase(n_objects: int) -> tuple:
    from gatekeeper_tpu_torch.ops import fold
    from gatekeeper_tpu_torch.utils.synthetic import make_cluster_objects

    t0 = time.perf_counter()
    objects = make_cluster_objects(n_objects, seed=0)
    log(f"generated {n_objects} objects in {time.perf_counter() - t0:.1f}s")
    launches = {}
    shapes = {}
    results = {}
    runs = {}
    timings = {}
    for collect, kernel in (("reduced", "fused_fold"),
                            ("masks", "epilogue")):
        dispatches: list = []
        for wrapper in (fold.fused_fold, fold.epilogue):
            wrapper.launches = 0
            wrapper.shapes.clear()
        run, phases, dt = audit(objects, "cuda", collect, dispatches)
        counts = {"fused_fold": fold.fused_fold.launches,
                  "epilogue": fold.epilogue.launches}
        if counts[kernel] <= 0:
            raise AssertionError(f"{collect} lane never launched {kernel}")
        launches[kernel] = counts[kernel]
        shapes[kernel] = dict(getattr(fold, kernel).shapes)
        total = sum(run.total_violations.values())
        log(f"audit[{collect}]: {run.total_objects} objects, {total} "
            f"violations, {dt:.3f}s, {run.total_objects / dt:.1f} objects/s, "
            f"launches {counts}")
        log(f"phases[{collect}]: " + json.dumps(
            {k: round(v, 6) for k, v in sorted(phases.items())}))
        if run.incomplete or run.total_objects != n_objects or total <= 0:
            raise AssertionError(f"audit[{collect}] result is not sane")
        lanes = _lanes(phases)
        if set(lanes) != {"dict"}:
            raise AssertionError(f"audit[{collect}]: chunks left the native "
                                 f"dict columnizer: {lanes}")
        # the CEL rows ride the fold launches of their kind group
        with_cel = [(c, n) for kinds, c, n in dispatches
                    if set(CEL_TEMPLATE_KINDS) <= set(kinds)]
        if len(dispatches) != counts[kernel] or not with_cel:
            raise AssertionError(
                f"audit[{collect}]: {len(dispatches)} dispatches for "
                f"{counts[kernel]} {kernel} launches, {len(with_cel)} with "
                f"both CEL kinds")
        cel_totals = {f"{kind}/{name}": v for (kind, name), v in
                      sorted(run.total_violations.items())
                      if kind in CEL_TEMPLATE_KINDS}
        log(f"audit[{collect}]: {len(with_cel)} of {len(dispatches)} "
            f"{kernel} launches carry both CEL kinds' rows at (C, N) "
            f"{sorted(set(with_cel))}; CEL constraint totals {cel_totals}")
        if len(cel_totals) != len(CEL_TEMPLATE_KINDS) or \
                min(cel_totals.values()) <= 0:
            raise AssertionError(f"audit[{collect}]: a CEL constraint has "
                                 f"no violations: {cel_totals}")
        results[collect] = summary(run)
        runs[collect] = run
        timings[collect] = (dt, phases)
    if results["reduced"] != results["masks"]:
        raise AssertionError("reduced and masks lanes disagree")
    prefix = objects[:CPU_PREFIX]
    on_card = summary(audit(prefix, "cuda", "reduced")[0])
    on_cpu = summary(audit(prefix, "cpu", "reduced")[0])
    if on_card != on_cpu:
        raise AssertionError("CPU run of the port differs from the card's")
    log(f"cpu == cuda on the first {CPU_PREFIX} objects "
        f"({sum(on_cpu[1].values())} violations)")
    return launches, shapes, objects, runs, on_card, timings


# the pipeline, snapshot, expand, extdata, hooks (b)-(c) and profile phases'
# objects: the path phase's first, cut from its 131,072 and then 65,536 for
# the time limit (still two chunks of 32,768, so every multi-chunk gate has
# chunks to compare)
DEPTH_OBJECTS = 40960


def depth_references(objects, relist_runs, timings) -> tuple:
    """The first ``DEPTH_OBJECTS`` objects, their relist runs on both
    collect lanes (the path phase's own where it has no more objects),
    which must agree, and each lane's (seconds, phases)."""
    deep = objects[:DEPTH_OBJECTS]
    if len(deep) == len(objects):
        return deep, relist_runs, timings
    runs = {}
    deep_timings = {}
    for collect in ("reduced", "masks"):
        run, phases, dt = audit(deep, "cuda", collect)
        if run.incomplete or run.total_objects != len(deep):
            raise AssertionError(f"depth[{collect}] result is not sane")
        runs[collect] = run
        deep_timings[collect] = (dt, phases)
        log(f"depth[{collect}]: {run.total_objects} objects, "
            f"{sum(run.total_violations.values())} violations, {dt:.3f}s")
    if summary(runs["reduced"]) != summary(runs["masks"]):
        raise AssertionError(f"depth: the lanes disagree on the first "
                             f"{len(deep)} objects")
    return deep, runs, deep_timings


# --- the audit's host path: schedules, lanes, worker processes --------------
PIPE_DIFF_PREFIX = 4096  # objects of the differential runs (d)
# the default schedule's relists may take at most this share of the serial
# ones' wall, summed over two runs of each in ABBA order: single relists of
# these objects on the H100 host, same code, differed by up to 21% (11.118
# against 13.466 s); the pipelined default took 1.21-1.56x
DEFAULT_WALL_NOISE = 1.3
_PIPE_KEYS = ("flatten", "fl_c_columnize", "wire_pack", "upload",
              "h2d_bytes", "h2d_copies", "dispatch", "collect")


def pipeline_audit(objects, listed, collect: str, pipeline: str,
                   flatten_lane: str = "auto", flatten_workers: int = 0,
                   device: str = "cuda") -> tuple:
    """(manager, evaluator) of one library relist over ``listed`` (dicts
    or pre-serialized ``RawJSON``) with the path phase's settings and the
    given schedule, columnizer lane and flatten worker processes; the
    client's inventory comes from ``objects``."""
    from gatekeeper_tpu_torch.audit.manager import AuditConfig, AuditManager
    from gatekeeper_tpu_torch.parallel.sweep import SweepEvaluator

    client, driver, _nt, _nc = _client(objects, device=device)
    evaluator = SweepEvaluator(driver, device=device, violations_limit=20,
                               collect=collect, flatten_lane=flatten_lane,
                               flatten_workers=flatten_workers)
    mgr = AuditManager(client, lister=lambda: iter(listed),
                       config=AuditConfig(violations_limit=20,
                                          chunk_size=32768,
                                          exact_totals=False,
                                          submit_window=4,
                                          pipeline=pipeline),
                       evaluator=evaluator)
    return mgr, evaluator


def _pipelined_counted(mgr, launches: dict, shapes: dict) -> None:
    """Count the fold kernels' launches and shapes inside ``mgr``'s
    pipelined sweeps only (not its serial ones)."""
    mgr._sweep_pipelined = _fold_counted(mgr._sweep_pipelined, launches,
                                         shapes)


def _lanes(perf: dict) -> dict:
    return {k.split("/", 1)[1]: int(v) for k, v in perf.items()
            if k.startswith("flatten_chunks/")}


def _pipe_record(label: str, mgr, ev, run, wall: float, cores: tuple,
                 card: str) -> dict:
    perf = {**ev.perf, **mgr.perf}
    rec = {"wall_s": wall, "objects": run.total_objects,
           "objects_per_s": run.total_objects / wall,
           "fold_render": perf.get("fold_render", 0.0),
           "lanes": _lanes(ev.perf),
           "fanout_chunks": int(ev.perf.get("flatten_fanout_chunks", 0)),
           **{k: perf.get(k, 0.0) for k in _PIPE_KEYS}}
    log(f"pipeline[{label}]: {run.total_objects} objects, "
        f"{sum(run.total_violations.values())} violations, {wall:.3f}s, "
        f"{rec['objects_per_s']:.1f} objects/s; " + ", ".join(
            f"{k} {rec[k]:.6f}" for k in _PIPE_KEYS + ("fold_render",))
        + f"; lanes {rec['lanes']}; os.cpu_count() {cores[0]}, "
        f"effective {cores[1]}; {card}")
    if mgr.pipe_stats is not None:
        rec["pipe"] = mgr.pipe_stats
        log(f"pipeline[{label}]: stages " + json.dumps(mgr.pipe_stats))
    return rec


def _vocab_bijection(vocab) -> bool:
    return len(vocab._to_str) == len(vocab._to_id) and all(
        vocab._to_id[s] == i for i, s in enumerate(vocab._to_str))


def _htod_copies(prof) -> int:
    """Host-to-device memcpy events the profiler saw on the device."""
    return sum(e.count for e in _device_events(prof) if "HtoD" in e.key)


def pipeline_phase(objects, relist_runs, prefix_summary, card: str,
                   device: str = "cuda") -> tuple:
    """The relist on the path phase's objects under each host path:
    (a0) a dict lister on the default schedule (``auto``) and (a) that
    lister, serial, twice each in ABBA order, where (a0)'s walls may sum to
    DEFAULT_WALL_NOISE times (a)'s at most; (b) a ``RawJSON`` lister (serialized
    before the timer starts), serial, ``flatten_lane="raw"``; (c) the
    ``RawJSON`` lister pipelined, raw lane, W flatten worker processes;
    (d) on the first PIPE_DIFF_PREFIX objects, ``pipeline="differential"``
    with the ``RawJSON`` lister and W workers on both collect lanes; then
    (c) once more, warm and under ``torch.profiler``, for the
    host-to-device copies.  Returns (launches, shapes) of the fold
    kernels inside the pipelined sweeps, and the runs' records.
    ``device="cpu"`` rehearses it (no profile, no launches)."""
    import os

    from gatekeeper_tpu_torch.audit.manager import AuditConfig
    from gatekeeper_tpu_torch.ops import native
    from gatekeeper_tpu_torch.ops.flatten import shutdown_flatten_pools
    from gatekeeper_tpu_torch.pipeline import effective_cpu_count
    from gatekeeper_tpu_torch.utils.rawjson import as_raw

    cores = (os.cpu_count(), effective_cpu_count())
    workers = max(2, min(4, cores[1] - 2))
    if native.load() is None or native.load_json() is None:
        raise AssertionError("pipeline: a native columnizer did not build")
    t0 = time.perf_counter()
    raws = [as_raw(o) for o in objects]
    log(f"pipeline: {len(raws)} objects serialized in "
        f"{time.perf_counter() - t0:.3f}s; flatten workers {workers}; "
        f"os.cpu_count() {cores[0]}, effective {cores[1]}")
    launches = {"fused_fold": 0, "epilogue": 0}
    shapes = {name: collections.Counter() for name in launches}
    want = summary(relist_runs["reduced"])
    default = AuditConfig().pipeline
    records = {}
    try:
        for label, listed, pipeline, lane, w in (
                ("a0 dict default", objects, default, "auto", 0),
                ("a dict serial", objects, "off", "auto", 0),
                ("a' dict serial", objects, "off", "auto", 0),
                ("a0' dict default", objects, default, "auto", 0),
                ("b raw serial", raws, "off", "raw", 0),
                ("c raw pipelined", raws, "on", "raw", workers)):
            mgr, ev = pipeline_audit(objects, listed, "reduced", pipeline,
                                     lane, w, device=device)
            _pipelined_counted(mgr, launches, shapes)
            gc.collect()  # the last run's garbage, before the timer
            t0 = time.perf_counter()
            run = mgr.audit()
            if device == "cuda":
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            records[label] = rec = _pipe_record(label, mgr, ev, run, wall,
                                                cores, card)
            if summary(run) != want or run.incomplete:
                raise AssertionError(f"pipeline[{label}]: differs from the "
                                     f"path phase's relist")
            if lane == "raw" and not set(rec["lanes"]) <= {"raw",
                                                           "raw+workers"}:
                raise AssertionError(f"pipeline[{label}]: a chunk missed "
                                     f"the raw lane: {rec['lanes']}")
            if pipeline == "on":
                if mgr.perf.get("pipelined") != 1.0 or \
                        mgr.perf.get("degraded_to_serial"):
                    raise AssertionError(f"pipeline[{label}]: not pipelined "
                                         f"or degraded: {mgr.perf}")
                if rec["lanes"].get("raw+workers", 0) != \
                        rec["fanout_chunks"] or not rec["fanout_chunks"] \
                        or ev.perf.get("fl_worker_fallbacks"):
                    raise AssertionError(
                        f"pipeline[{label}]: chunks missed the workers: "
                        f"{rec['lanes']}, {rec['fanout_chunks']} chunks "
                        f"fan out")
                if not _vocab_bijection(ev.driver.vocab):
                    raise AssertionError(f"pipeline[{label}]: the vocab is "
                                         f"not a bijection")
                piped = (mgr, ev)
            if label.startswith("a0"):
                _schedule_held(f"pipeline[{label}]", mgr.perf)
        # the main path's schedule (the default) is no slower than serial
        ratio = sum(records[k]["wall_s"] for k in ("a0 dict default",
                                                   "a0' dict default")) / \
            sum(records[k]["wall_s"] for k in ("a dict serial",
                                               "a' dict serial"))
        log(f"pipeline: the default schedule's walls over the serial ones' "
            f"{ratio:.3f} (at most {DEFAULT_WALL_NOISE})")
        if device == "cuda" and ratio > DEFAULT_WALL_NOISE:
            raise AssertionError(f"pipeline: the default schedule takes "
                                 f"{ratio:.3f}x the serial relist's wall")
        # (d) the differential schedule on both collect lanes
        prefix, raw_prefix = objects[:PIPE_DIFF_PREFIX], \
            raws[:PIPE_DIFF_PREFIX]
        diff_runs = {}
        for collect in ("reduced", "masks"):
            label = f"d differential {collect}"
            mgr, ev = pipeline_audit(prefix, raw_prefix, collect,
                                     "differential", "raw", workers,
                                     device=device)
            _pipelined_counted(mgr, launches, shapes)
            t0 = time.perf_counter()
            run = mgr.audit()
            wall = time.perf_counter() - t0
            records[label] = _pipe_record(label, mgr, ev, run, wall, cores,
                                          card)
            if mgr.perf.get("pipeline_differential_ok") != 1.0 or \
                    mgr.pipe_stats is None or \
                    mgr.perf.get("degraded_to_serial"):
                raise AssertionError(f"pipeline[{label}]: {mgr.perf}")
            diff_runs[collect] = summary(run)
        if not diff_runs["reduced"] == diff_runs["masks"] == prefix_summary:
            raise AssertionError("pipeline[d]: the differential runs differ "
                                 "from the path phase's prefix run")
        if device == "cuda":
            if min(launches.values()) <= 0:
                raise AssertionError(f"pipeline: a fold kernel was never "
                                     f"launched in the pipelined runs: "
                                     f"{launches}")
            records["copies"] = pipeline_copies(*piped, cores, card)
    finally:
        shutdown_flatten_pools()
    log(f"pipeline: launches inside the pipelined sweeps {launches}, "
        f"shapes {dict((k, dict(v)) for k, v in shapes.items())}")
    return launches, {k: dict(v) for k, v in shapes.items()}, records


def pipeline_copies(mgr, ev, cores: tuple, card: str) -> dict:
    """Run (c)'s manager once more, warm, under ``torch.profiler``: the
    host-to-device copies the device saw must not exceed, summed over the
    relist's chunks, one per dtype buffer plus the mask's, plus the
    counted misses of the table and parameter caches."""
    from torch.profiler import ProfilerActivity, profile

    ev.perf_reset()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run = mgr.audit()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    p = ev.perf
    chunks = int(p.get("h2d_mask_copies", 0))
    allowed = int(p.get("h2d_col_buffers", 0) + chunks
                  + p.get("h2d_table_misses", 0)
                  + p.get("h2d_param_misses", 0))
    seen = _htod_copies(prof)
    rec = {"chunks": chunks, "col_buffers": int(p.get("h2d_col_buffers", 0)),
           "table_misses": int(p.get("h2d_table_misses", 0)),
           "param_misses": int(p.get("h2d_param_misses", 0)),
           "counted": int(p.get("h2d_copies", 0)), "allowed": allowed,
           "profiler_htod": seen, "wall_s": wall}
    log(f"pipeline[c warm, profiled]: {run.total_objects} objects in "
        f"{wall:.3f}s; host-to-device copies: profiler {seen}, counted "
        f"{rec['counted']}, allowed {allowed} ({chunks} chunks, "
        f"{rec['col_buffers']} dtype buffers, {chunks} masks, "
        f"{rec['table_misses']} table and {rec['param_misses']} parameter "
        f"cache misses); {card}")
    if not _device_events(prof):
        raise AssertionError("pipeline: the profiler reported no device "
                             "events, so the copy gate cannot be held")
    if not 0 < seen <= allowed or rec["counted"] != allowed:
        raise AssertionError(f"pipeline: {seen} host-to-device copies for "
                             f"{allowed} allowed")
    return rec


def snapshot_churn(objects, n: int, seed: int = 5) -> list:
    """``n`` watch operations over ``objects`` (as ("apply"|"delete",
    obj)): half label edits, a quarter ``privileged: true`` on a Pod's
    first container (verdicts flip), an eighth deletes, an eighth new
    Pods.  Distinct objects per operation; made from ``seed``."""
    rng = np.random.default_rng(seed)
    n_priv, n_del, n_add = n // 4, n // 8, n // 8
    n_lab = n - n_priv - n_del - n_add
    order = rng.permutation(len(objects)).tolist()
    pods = [i for i in order if objects[i].get("kind") == "Pod"
            and (objects[i].get("spec") or {}).get("containers")]
    priv = set(pods[:n_priv])
    rest = [i for i in order if i not in priv]
    ops = []
    for i in rest[:n_lab]:
        o = copy.deepcopy(objects[i])
        o.setdefault("metadata", {}).setdefault("labels", {})["churn"] = \
            f"tick-{seed}"
        ops.append(("apply", o))
    for i in sorted(priv):
        o = copy.deepcopy(objects[i])
        o["spec"]["containers"][0].setdefault(
            "securityContext", {})["privileged"] = True
        ops.append(("apply", o))
    for i in rest[n_lab: n_lab + n_del]:
        ops.append(("delete", copy.deepcopy(objects[i])))
    for j, i in enumerate(pods[n_priv: n_priv + n_add]):
        o = copy.deepcopy(objects[i])
        o["metadata"]["name"] = f"churn-add-{seed}-{j}"
        ops.append(("apply", o))
    return ops


def snapshot_world(objects, device: str, collect: str, mode: str,
                   generation_swap: bool = False, watch: bool = True):
    """(manager, cluster, ingester, residency, snapshot, evaluator): the
    CLI's ``--audit-source snapshot`` stack over ``objects``, with the
    path phase's audit settings.  ``generation_swap`` gives the driver a
    generation coordinator (not started) that evicts the residency at a
    swap; without ``watch`` the ingester is made but not started (a spill
    load comes first)."""
    from gatekeeper_tpu_torch.audit.manager import AuditConfig, AuditManager
    from gatekeeper_tpu_torch.parallel.sweep import SweepEvaluator
    from gatekeeper_tpu_torch.snapshot import (ClusterSnapshot,
                                               DeviceResidency,
                                               SnapshotConfig, WatchIngester,
                                               gvks_of)
    from gatekeeper_tpu_torch.sync.source import FakeCluster

    client, driver, _nt, _nc = _client(objects, device=device,
                                       generation_swap=generation_swap)
    evaluator = SweepEvaluator(driver, device=device, violations_limit=20,
                               collect=collect)
    cluster = FakeCluster()
    for o in objects:
        cluster.apply(o)
    snap = ClusterSnapshot(evaluator, SnapshotConfig())
    ingester = WatchIngester(snap, cluster, gvks_of(cluster.list()))
    if watch:
        ingester.start()
    residency = DeviceResidency(evaluator, mode=mode)
    if driver.gen_coord is not None:
        driver.gen_coord.attach_residency(residency)
    mgr = AuditManager(client, lister=cluster.list,
                       config=AuditConfig(violations_limit=20,
                                          chunk_size=32768,
                                          exact_totals=False,
                                          submit_window=4,
                                          audit_source="snapshot"),
                       evaluator=evaluator, snapshot=snap,
                       residency=residency)
    return mgr, cluster, ingester, residency, snap, evaluator


def _timed(obj, name: str, acc: dict) -> None:
    """Wrap ``obj.name`` so its wall seconds add up in ``acc[name]``."""
    fn = getattr(obj, name)

    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            acc[name] = acc.get(name, 0.0) + time.perf_counter() - t0

    setattr(obj, name, timed)


def _churn_apply(cluster, ops) -> None:
    for op, obj in ops:
        (cluster.apply if op == "apply" else cluster.delete)(obj)


def snapshot_lane(objects, relist_run, collect: str, card: str,
                  device: str = "cuda") -> dict:
    """Steps 1-5 of the snapshot phase on one collect lane, on ``device``
    (residency ``auto`` on the card; ``on`` for a CPU rehearsal)."""
    from gatekeeper_tpu_torch.audit.manager import AuditManager

    mgr, cluster, ingester, residency, snap, ev = snapshot_world(
        objects, device, collect, "auto" if device == "cuda" else "on")
    if not residency.available():
        raise AssertionError("residency declined on the card")
    acc: dict = {}
    _timed(snap, "rebuild", acc)
    _timed(residency, "_upload", acc)
    _timed(residency, "_patch", acc)
    n_churn = max(8, int(len(objects) * CHURN_SHARE))
    ops = snapshot_churn(objects, n_churn)
    out = {"steps": {}}
    try:
        def step(name, fn, churn=None):
            acc.clear()
            perf0 = dict(ev.perf)
            patched0 = residency.patched_rows
            t0 = time.perf_counter()
            run = fn()
            if device == "cuda":
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            d = {k: ev.perf.get(k, 0.0) - perf0.get(k, 0.0)
                 for k in ("dispatch", "upload", "collect")}
            rec = {"wall_s": wall,
                   "objects_per_s": run.total_objects / wall,
                   "rows": mgr.perf.get("last_rows_evaluated", 0.0),
                   "h2d_bytes": mgr.perf.get("tick_h2d_bytes", 0.0),
                   "resident_mb": residency.resident_bytes() / 1e6,
                   "rows_patched": residency.patched_rows - patched0,
                   "build_s": acc.get("rebuild", 0.0),
                   "residency_upload_s": acc.get("_upload", 0.0),
                   "residency_patch_s": acc.get("_patch", 0.0),
                   "dispatch_s": d["dispatch"], "tables_s": d["upload"],
                   "collect_s": d["collect"],
                   "violations": sum(run.total_violations.values())}
            out["steps"][name] = rec
            log(f"snapshot[{collect}] {name}: {run.total_objects} objects, "
                f"{rec['violations']} violations, {wall:.3f}s, "
                f"{rec['objects_per_s']:.1f} objects/s, "
                f"{rec['rows']:.0f} rows evaluated, h2d "
                f"{rec['h2d_bytes']:.0f} bytes, resident "
                f"{rec['resident_mb']:.3f} MB, {rec['rows_patched']} rows "
                f"patched; build (flatten) {rec['build_s']:.3f}s, residency "
                f"upload {rec['residency_upload_s']:.3f}s / patch "
                f"{rec['residency_patch_s']:.3f}s, dispatch "
                f"{rec['dispatch_s']:.3f}s, tables {rec['tables_s']:.3f}s, "
                f"collect {rec['collect_s']:.3f}s ({card})")
            if run.incomplete:
                raise AssertionError(f"snapshot[{collect}] {name}: "
                                     f"incomplete run")
            return run, rec

        run1, _ = step("1 build+upload+audit", mgr.audit)
        run2, rec2 = step("2 resident audit", mgr.audit)
        for label, run in (("1", run1), ("2", run2)):
            diff = AuditManager._verdicts_differ_canonical(
                run.kept, run.total_violations, relist_run.kept,
                relist_run.total_violations, 20)
            if diff is not None or run.total_objects != len(objects):
                raise AssertionError(f"snapshot[{collect}] step {label} "
                                     f"differs from the relist run: {diff}")
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _run2b, rec2b = step("2 repeated, profiled", mgr.audit)
        if rec2b["h2d_bytes"] != 0:
            raise AssertionError(f"snapshot[{collect}]: the repeat of step "
                                 f"2 uploaded {rec2b['h2d_bytes']} bytes")
        events = _device_events(prof)
        if events:
            busy_ms = sum(dev_us(e) for e in events) / 1e3
            idle = 1 - busy_ms / (rec2b["wall_s"] * 1e3)
            out["idle_share"] = idle
            top = sorted(events, key=dev_us, reverse=True)[:5]
            log(f"snapshot[{collect}] profile of step 2: wall "
                f"{rec2b['wall_s'] * 1e3:.1f} ms (profiled), device busy "
                f"{busy_ms:.3f} ms, idle share {idle:.4f}; top: "
                + "; ".join(f"{e.key[:50]} x{e.count} "
                            f"{dev_us(e) / 1e3:.3f} ms" for e in top))
        else:
            log(f"snapshot[{collect}] profile: the profiler reported no "
                f"device events; idle share not measured")
        _run3, rec3 = step("3 clean tick", mgr.audit_tick)
        if rec3["rows"] != 0 or rec3["h2d_bytes"] != 0:
            raise AssertionError(f"snapshot[{collect}]: the clean tick "
                                 f"evaluated {rec3['rows']} rows")
        _churn_apply(cluster, ops)
        ingester.pump()
        dirty = snap.dirty_count()
        _run4, rec4 = step(f"4 churn tick ({len(ops)} operations)",
                           mgr.audit_tick)
        resident = residency.resident_bytes()
        if not 0 < rec4["rows"] <= dirty or rec4["rows"] > len(ops):
            raise AssertionError(f"snapshot[{collect}]: the churn tick "
                                 f"evaluated {rec4['rows']} rows for "
                                 f"{dirty} dirty")
        if not 0 < rec4["h2d_bytes"] < 0.05 * resident:
            raise AssertionError(f"snapshot[{collect}]: the churn tick "
                                 f"uploaded {rec4['h2d_bytes']} of "
                                 f"{resident} resident bytes")
        lowered = [s for s in snap.routed_stores() if s.lowered]
        promoted = sum(residency.is_resident(s) for s in lowered)
        host_chunks = mgr.perf.get("snapshot_host_chunks", 0.0)
        log(f"snapshot[{collect}]: {promoted} of {len(lowered)} lowered "
            f"groups resident, "
            f"{mgr.perf.get('snapshot_resident_chunks', 0.0):.0f} resident "
            f"chunks, {host_chunks:.0f} host-column chunks, residency "
            f"{residency.stats()}")
        if promoted != len(lowered) or not lowered or host_chunks:
            raise AssertionError(f"snapshot[{collect}]: a group served "
                                 f"host columns")
        out["direct"] = None
        if collect == "reduced":
            # one budgeted resident dispatch: fused_fold on a gathered
            # chunk (snapshot passes take the complete variant)
            store = max(lowered, key=lambda s: s.live_count)
            rg = residency.prepare(store)
            positions = store.live_positions()[:32768]
            got = ev.sweep_collect(ev.sweep_dispatch(
                ev.sweep_flatten_resident(rg, positions,
                                          return_bits=False)))
            out["direct"] = (store, positions, got)
        out["churn_violations"] = rec4["violations"]
        return out
    finally:
        ingester.stop()


def snapshot_cpu_equal(objects) -> None:
    """The card's snapshot lane equals a CPU snapshot run on ``objects``,
    step by step (full pass, resident pass, churn tick, resync), and each
    resync finds no difference."""
    sums = {}
    for device, mode in (("cuda", "auto"), ("cpu", "on")):
        mgr, cluster, ingester, residency, _snap, _ev = snapshot_world(
            objects, device, "reduced", mode)
        try:
            got = [summary(mgr.audit()), summary(mgr.audit())]
            _churn_apply(cluster, snapshot_churn(
                objects, max(8, int(len(objects) * CHURN_SHARE))))
            ingester.pump()
            got.append(summary(mgr.audit_tick()))
            got.append(summary(mgr.audit_resync()))
            if mgr.last_resync_diff is not None:
                raise AssertionError(f"snapshot on {device}: resync "
                                     f"differs: {mgr.last_resync_diff}")
        finally:
            ingester.stop()
        if not residency.upload_count:
            raise AssertionError(f"snapshot on {device}: nothing resident")
        sums[device] = got
    if sums["cuda"] != sums["cpu"]:
        raise AssertionError("snapshot: the CPU run differs from the card's")
    log(f"snapshot: cpu == cuda on the first {len(objects)} objects, step "
        f"by step ({[sum(s[1].values()) for s in sums['cpu']]} violations), "
        f"resync diff None on both")


def snapshot_phase(objects, relist_runs, card: str,
                   device: str = "cuda") -> tuple:
    """The resident snapshot on both collect lanes: (launches, shapes) of
    the fold kernels over the snapshot path's runs, and each lane's steps.
    ``device="cpu"`` rehearses it without the card (and without the
    card-against-CPU comparison)."""
    from gatekeeper_tpu_torch.ops import fold

    launches, shapes, direct = {}, {}, None
    for wrapper in (fold.fused_fold, fold.epilogue):
        wrapper.launches = 0
        wrapper.shapes.clear()
    results = {}
    for collect in ("reduced", "masks"):
        out = snapshot_lane(objects, relist_runs[collect], collect, card,
                            device)
        results[collect] = out
        if out["direct"] is not None:
            direct = out["direct"]
    for name in ("fused_fold", "epilogue"):
        wrapper = getattr(fold, name)
        launches[name] = wrapper.launches
        shapes[name] = dict(wrapper.shapes)
    log(f"snapshot: launches {launches}, shapes {shapes}")
    if device == "cuda" and min(launches.values()) <= 0:
        raise AssertionError(f"snapshot path: a fold kernel never "
                             f"launched: {launches}")
    # the direct resident dispatch against a host-column dispatch of the
    # same rows (after the count was read)
    store, positions, got = direct
    ev = store.evaluator
    batch = store.slice_rows(positions, ev._pad(len(positions)))
    want = ev.sweep_collect(ev.sweep_dispatch(ev.sweep_flatten_from_batch(
        store.cons, batch, [store.row_obj(p) for p in positions],
        return_bits=False, alias=store.alias)))
    for kind in want:
        for a, b in zip(got[kind][1:4], want[kind][1:4]):
            if not np.array_equal(a, b):
                raise AssertionError(f"resident fused_fold dispatch of "
                                     f"{kind} differs from host columns")
    log(f"snapshot: the budgeted resident dispatch of {len(positions)} rows "
        f"equals the host-column dispatch ({len(want)} kinds)")
    if results["reduced"]["churn_violations"] != \
            results["masks"]["churn_violations"]:
        raise AssertionError("snapshot: reduced and masks lanes disagree")
    if device == "cuda":
        snapshot_cpu_equal(objects[:CPU_PREFIX])
    return launches, shapes, {c: {k: v for k, v in r.items()
                                  if k != "direct"}
                              for c, r in results.items()}


def dev_us(e) -> float:
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0.0))


def _device_events(prof) -> list:
    """Device-side events only (kernels, memcpy, memset): the aten ops
    that launched them carry the same time again."""
    return [e for e in prof.key_averages() if dev_us(e) > 0
            and str(getattr(e, "device_type", "")).endswith("CUDA")]


def profile_phase(objects) -> None:
    """Device busy time of one reduced-lane audit (sum of the device
    events' self time; one stream, so they do not overlap) against its wall
    time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _run, _phases, wall = audit(objects, "cuda", "reduced")
    events = _device_events(prof)
    if not events:
        log("profile[reduced]: the profiler reported no device events; "
            "device busy time not measured")
        return
    busy_ms = sum(dev_us(e) for e in events) / 1e3
    top = sorted(events, key=dev_us, reverse=True)[:6]
    log(f"profile[reduced]: wall {wall * 1e3:.1f} ms (profiled), device "
        f"busy {busy_ms:.3f} ms, idle share "
        f"{1 - busy_ms / (wall * 1e3):.4f}; top: " + "; ".join(
            f"{e.key[:60]} x{e.count} {dev_us(e) / 1e3:.3f} ms"
            for e in top))
    # the fold kernel as the audit launched it (inputs as the path leaves
    # them), beside the graph-replay time of the kernel phase
    for e in events:
        if "fold_rows" in e.key:
            log(f"profile[reduced]: {e.key[:60]} x{e.count}, "
                f"{dev_us(e) / 1e3 / e.count:.5f} ms per launch")


def admission_body(obj: dict, uid: str, old: dict = None,
                   delete: bool = False) -> dict:
    """An AdmissionReview for ``obj`` as the apiserver sends it: CREATE,
    UPDATE when ``old`` (the oldObject) is given, or DELETE (``object``
    null, ``oldObject`` the object)."""
    group, _, version = obj.get("apiVersion", "").rpartition("/")
    meta = obj.get("metadata") or {}
    req = {"uid": uid, "operation": "CREATE" if old is None else "UPDATE",
           "kind": {"group": group, "version": version,
                    "kind": obj.get("kind", "")},
           "name": meta.get("name", ""),
           "namespace": meta.get("namespace", ""),
           "userInfo": {"username": "kubernetes-admin",
                        "groups": ["system:masters"]},
           "object": obj}
    if delete:
        req.update(operation="DELETE", object=None, oldObject=obj)
    elif old is not None:
        req["oldObject"] = old
    return {"apiVersion": "admission.k8s.io/v1", "kind": "AdmissionReview",
            "request": req}


def admission_traffic(n: int) -> tuple:
    """(bodies, objects): the library's sample objects, then synthetic
    cluster objects, ``n`` in all; every tenth body is an UPDATE whose
    oldObject differs (a Pod's service account, else a label), and every
    twentieth of the other bodies a DELETE."""
    import glob
    import os

    from gatekeeper_tpu_torch.utils.synthetic import (library_dir,
                                                      make_cluster_objects)
    from gatekeeper_tpu_torch.utils.unstructured import load_yaml_file

    samples = []
    for path in sorted(glob.glob(os.path.join(
            library_dir(), "*", "*", "samples", "example_*.yaml"))):
        samples.extend(d for d in load_yaml_file(path) if isinstance(d, dict))
    objects = (samples + make_cluster_objects(max(0, n - len(samples)),
                                              seed=3))[:n]
    bodies = []
    others = 0  # non-UPDATE bodies so far
    for i, obj in enumerate(objects):
        old = None
        delete = False
        if i % 10 != 9:
            others += 1
            delete = others % 20 == 0
        else:
            old = copy.deepcopy(obj)
            if obj.get("kind") == "Pod":
                old.setdefault("spec", {})["serviceAccountName"] = "prior-sa"
            else:
                old.setdefault("metadata", {}).setdefault(
                    "labels", {})["revision"] = "prior"
        bodies.append(admission_body(obj, f"adm-{i}", old, delete))
    return bodies, objects


# One load process: ``conns`` threads, each posting its part of the share
# to ``path`` over one keep-alive connection, one request at a time.  It
# reads its share ([[index, body text]]) as one line of stdin, says "ready",
# posts on the next line of stdin and writes [[index, latency s, status,
# reply text, Retry-After header or null]] to stdout.  Standard library only, so it starts in tens of
# milliseconds: no numpy, no torch.
_LOAD_CLIENT = r"""
import http.client, json, sys, threading, time
port, path, conns = int(sys.argv[1]), sys.argv[2], int(sys.argv[3])
share = json.loads(sys.stdin.readline())
out, lock = [], threading.Lock()

def client(part):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    try:
        for idx, body in part:
            t0 = time.perf_counter()
            conn.request("POST", path, body=body.encode(),
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            reply = resp.read()
            dt = time.perf_counter() - t0
            with lock:
                out.append((idx, dt, resp.status, reply.decode(),
                            resp.getheader("Retry-After")))
    finally:
        conn.close()

threads = [threading.Thread(target=client, args=(share[c::conns],))
           for c in range(conns)]
print("ready", flush=True)
sys.stdin.readline()
for t in threads:
    t.start()
for t in threads:
    t.join()
json.dump(out, sys.stdout)
"""
LOAD_DEADLINE_S = 600.0


def post_concurrently(port: int, bodies: list,
                      path: str = "/v1/admit",
                      retry_after: dict = None, procs: int = None,
                      conns: int = None) -> tuple:
    """Post every body to ``path`` from ``procs`` processes x ``conns``
    keep-alive connections (LOAD_PROCS x LOAD_CONNS by default).  Returns
    (replies by index, latencies s, wall
    s); ``retry_after`` (a dict) receives each reply's ``Retry-After``
    header by index, where it has one.  Each process runs ``_LOAD_CLIENT`` under this interpreter and is
    waited for (or killed past ``LOAD_DEADLINE_S``) before this returns, so
    no client outlives the call."""
    n_procs = procs or LOAD_PROCS
    items = [(i, json.dumps(b)) for i, b in enumerate(bodies)]
    procs = [subprocess.Popen(
        [sys.executable, "-c", _LOAD_CLIENT, str(port), path,
         str(conns or LOAD_CONNS)], stdin=subprocess.PIPE,
        stdout=subprocess.PIPE, text=True) for _ in range(n_procs)]

    def kill_all():
        for proc in procs:
            if proc.poll() is None:
                proc.kill()

    watchdog = threading.Timer(LOAD_DEADLINE_S, kill_all)
    watchdog.daemon = True
    watchdog.start()
    t_start = time.perf_counter()
    try:
        for p, proc in enumerate(procs):
            proc.stdin.write(json.dumps(items[p::n_procs]) + "\n")
            proc.stdin.flush()
        for p, proc in enumerate(procs):
            if proc.stdout.readline() != "ready\n":
                raise AssertionError(f"load process {p} did not start")
        t0 = time.perf_counter()
        for proc in procs:
            proc.stdin.write("go\n")
            proc.stdin.close()
        rows = []
        for p, proc in enumerate(procs):
            text = proc.stdout.read()
            if proc.wait() != 0 or not text:
                raise AssertionError(
                    f"load process {p} exited {proc.returncode}")
            rows.extend(json.loads(text))
        wall = time.perf_counter() - t0
        log(f"load processes: ready {t0 - t_start:.3f}s, posting and "
            f"joined {wall:.3f}s")
    finally:
        watchdog.cancel()
        kill_all()
        for proc in procs:
            proc.wait()
            proc.stdout.close()
            if not proc.stdin.closed:
                proc.stdin.close()
    replies = {}
    for idx, _dt, status, reply, retry in rows:
        if status != 200:
            raise AssertionError(f"admission {idx}: HTTP {status}")
        replies[idx] = json.loads(reply)["response"]
        if retry is not None and retry_after is not None:
            retry_after[idx] = retry
    if len(replies) != len(bodies):
        raise AssertionError(f"{len(replies)} of {len(bodies)} answered")
    return replies, [r[1] for r in rows], wall


def _answer(resp: dict) -> tuple:
    status = resp.get("status") or {}
    return (resp["allowed"], status.get("code", 200),
            status.get("message", ""), sorted(resp.get("warnings") or []))


def _unordered(answer: tuple) -> tuple:
    """An answer with its deny message as the sorted list of its lines
    (one line per violated constraint)."""
    allowed, code, message, warnings = answer
    return allowed, code, sorted(message.split("\n")), warnings


def profile_grid_batch(client, bodies, namespaces) -> None:
    """One grid-lane batch (``client.review_batch``, as the batcher calls
    it) under ``torch.profiler``: the device's busy time beside the
    batch's wall time."""
    from torch.profiler import ProfilerActivity, profile

    from gatekeeper_tpu_torch.apis.constraints import WEBHOOK_EP
    from gatekeeper_tpu_torch.match.match import SOURCE_ORIGINAL
    from gatekeeper_tpu_torch.target.review import AugmentedReview
    from gatekeeper_tpu_torch.webhook.policy import parse_admission_review

    reviews = []
    for body in bodies:
        req = parse_admission_review(copy.deepcopy(body))
        reviews.append(AugmentedReview(
            admission_request=req, namespace=namespaces.get(req.namespace),
            source=SOURCE_ORIGINAL, is_admission=True))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        client.review_batch(reviews, enforcement_point=WEBHOOK_EP)
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = _device_events(prof)
    if not events:
        log("admission profile: the profiler reported no device events; "
            "device busy time not measured")
        return
    busy_ms = sum(dev_us(e) for e in events) / 1e3
    top = sorted(events, key=dev_us, reverse=True)[:4]
    log(f"admission profile: one grid batch of {len(reviews)}, wall "
        f"{wall_ms:.3f} ms (profiled), device busy {busy_ms:.3f} ms, idle "
        f"share {1 - busy_ms / wall_ms:.4f}; top: " + "; ".join(
            f"{e.key[:50]} x{e.count} {dev_us(e) / 1e3:.3f} ms"
            for e in top))


def _cpu_answers(objects, namespaces, bodies, expansion_system=None,
                 extdata: bool = False) -> list:
    """The answer (``_answer``) of the port's in-process handler on the
    CPU without a batcher (the exact engines) to every body, over the
    inventory of ``objects`` and the Namespaces ``namespaces``."""
    from gatekeeper_tpu_torch.webhook.policy import ValidationHandler
    from gatekeeper_tpu_torch.webhook.server import admission_response

    ref_client = _client(objects, device="cpu", extdata=extdata)[0]
    # only given when set, so the served A/B tool can drive a checkout
    # whose handler predates expansion
    kw = {} if expansion_system is None else {
        "expansion_system": expansion_system}
    ref = ValidationHandler(ref_client, namespace_lookup=namespaces.get,
                            failure_policy="fail", **kw)
    out = []
    for body in bodies:
        v = ref.handle(copy.deepcopy(body))
        out.append(_answer(admission_response(v.uid, v.allowed, v.message,
                                              v.code, v.warnings)
                           ["response"]))
    return out


def _held_against_cpu(label: str, objects, namespaces, bodies,
                      replies, expansion_system=None,
                      extdata: bool = False, refs=None) -> tuple:
    """Hold every served answer against ``_cpu_answers`` (``refs`` when the
    caller has them), the deny message as its set of lines.  Raises on a
    difference; returns (denied, code 500)."""
    t0 = time.perf_counter()
    if refs is None:
        refs = _cpu_answers(objects, namespaces, bodies, expansion_system,
                            extdata)
    diffs, denied, code500, reordered = [], 0, 0, 0
    for i, want in enumerate(refs):
        got = _answer(replies[i])
        denied += not got[0]
        code500 += got[1] == 500
        reordered += got != want
        if _unordered(got) != _unordered(want):
            diffs.append((i, got, want))
    log(f"{label}: cpu reference handler {time.perf_counter() - t0:.3f}s; "
        f"{denied} denied, {len(diffs)} differ, {code500} with code 500, "
        f"{reordered} with the deny lines in another order")
    if diffs:
        raise AssertionError(f"{label}: served answers differ from the CPU "
                             f"handler, first: {diffs[:2]}")
    return denied, code500


def admission_phase(n: int, card: str, device: str = "cuda") -> dict:
    """Serve ``n`` admissions through the port's webhook on ``device``
    and hold every answer against the CPU exact-interpreter handler."""
    from gatekeeper_tpu_torch.__main__ import warm_batcher
    from gatekeeper_tpu_torch.webhook.namespacelabel import \
        NamespaceLabelHandler
    from gatekeeper_tpu_torch.webhook.policy import (Batcher,
                                                     ValidationHandler)
    from gatekeeper_tpu_torch.webhook.server import WebhookServer

    bodies, objects = admission_traffic(n)
    namespaces = {o["metadata"]["name"]: o for o in objects
                  if o.get("kind") == "Namespace"}
    client, driver, nt, nc = _client(objects, device=device)
    batcher = Batcher(client, stats=True).start()
    t0 = time.perf_counter()
    warm_batcher(client, batcher)
    log(f"admission: {nt} templates, {nc} constraints, {n} bodies; warm "
        f"{time.perf_counter() - t0:.3f}s")
    grid_stats: list = []
    errors: list = []
    cel_hits: list = []  # per grid batch: results of the CEL constraints
    delete_route: list = []  # CEL evaluations of DELETE reviews in batches
    in_batch = threading.local()
    query_batch = driver.query_batch
    cel_query = driver._cel.query

    def counted_cel_query(target, constraints, review, cfg=None):
        if getattr(in_batch, "on", False) and \
                review.request.operation == "DELETE":
            delete_route.append(len(constraints))
        return cel_query(target, constraints, review, cfg)

    def counted_query_batch(*args, **kwargs):
        in_batch.on = True
        try:
            out = query_batch(*args, **kwargs)
        except Exception as e:
            errors.append(repr(e))
            raise
        finally:
            in_batch.on = False
        for entry in out[0].stats_entries if out else ():
            grid_stats.append({s.name: s.value for s in entry.stats})
        cel_hits.append(sum(r.constraint.get("kind") in CEL_TEMPLATE_KINDS
                            for qr in out for r in qr.results))
        return out

    driver.query_batch = counted_query_batch
    driver._cel.query = counted_cel_query
    driver.perf.clear()
    server = WebhookServer(
        validation_handler=ValidationHandler(
            client, namespace_lookup=namespaces.get, batcher=batcher,
            failure_policy="fail",
            expansion_system=mutation_systems()[1]),
        namespace_label_handler=NamespaceLabelHandler(),
        host="127.0.0.1", port=0, batcher=batcher).start()
    try:
        replies, lat, wall = post_concurrently(server.port, bodies)
    finally:
        drained = server.stop()
    driver.query_batch = query_batch
    driver._cel.query = cel_query
    lanes = dict(batcher.lane_counts)
    sizes = dict(sorted(batcher.batch_sizes.items()))
    n_delete = sum(b["request"]["operation"] == "DELETE" for b in bodies)
    lat_ms = sorted(x * 1e3 for x in lat)
    out = {
        "admissions": n, "wall_s": wall, "admissions_per_s": n / wall,
        "p50_ms": lat_ms[len(lat_ms) // 2],
        "p99_ms": lat_ms[min(len(lat_ms) - 1, int(0.99 * len(lat_ms)))],
        "lanes": lanes, "batch_sizes": sizes,
        "grid_batches": len(grid_stats),
        "d2h_bytes": driver.perf.get("d2h_bytes", 0.0),
        "deletes": n_delete, "cel_delete_evaluations": len(delete_route),
        "cel_hits_per_grid_batch": cel_hits,
    }
    for name in ("flattenNS", "batchEvalNS", "totalNS"):
        vals = [g[name] for g in grid_stats]
        out[f"median_{name}"] = statistics.median(vals) if vals else None
    log(f"admission: {n} admissions in {wall:.3f}s, "
        f"{out['admissions_per_s']:.1f} admissions/s, p50 "
        f"{out['p50_ms']:.3f} ms, p99 {out['p99_ms']:.3f} ms "
        f"({LOAD_PROCS * LOAD_CONNS} keep-alive clients), {card}")
    log(f"admission: lanes {lanes}, batch sizes {sizes}")
    log(f"admission: {n_delete} DELETE bodies; {len(delete_route)} CEL "
        f"evaluations of DELETE reviews inside grid batches (the CEL "
        f"DELETE route); CEL hits per grid batch {cel_hits} "
        f"({sum(cel_hits)} in all)")
    log("admission: grid batch medians (ns): " + json.dumps(
        {k: out[f"median_{k}"] for k in ("flattenNS", "batchEvalNS",
                                         "totalNS")})
        + f", {out['grid_batches']} grid batches, d2h "
        f"{out['d2h_bytes']:.0f} bytes")

    if device == "cuda":
        profile_grid_batch(client, bodies[:batcher.max_batch], namespaces)
    denied, code500 = _held_against_cpu(
        "admission", objects, namespaces, bodies, replies,
        expansion_system=mutation_systems()[1])
    implied = sum(IMPLIED in (r.get("status") or {}).get("message", "")
                  for r in replies.values())
    out["implied_denials"] = implied
    log(f"admission: {implied} answers carry {IMPLIED} lines (the implied "
        f"Pods of Deployment bodies, reviewed with Source=Generated)")
    if not implied:
        raise AssertionError("admission: no implied-Pod denial")
    if errors:
        raise AssertionError(f"query_batch raised: {errors[:3]}")
    if code500 or not lanes.get("grid") or not grid_stats:
        raise AssertionError(f"admission not sane: {code500} code-500 "
                             f"answers, lanes {lanes}")
    if not delete_route or not sum(cel_hits):
        raise AssertionError(
            f"admission: the CEL DELETE route ran {len(delete_route)} "
            f"times, CEL constraints hit {sum(cel_hits)} times in grid "
            f"batches")
    if not drained or denied == 0:
        raise AssertionError("admission: server did not drain, or nothing "
                             "was denied")
    return out


def served_phase(n: int, n_objects: int, card: str,
                 device: str = "cuda") -> dict:
    """The served process's two threads on one driver and vocab, as the
    served CLI in snapshot mode runs them: ``n`` admissions through the
    webhook while the audit loop ticks and resyncs over a churning
    ``FakeCluster`` of ``n_objects`` (``__main__.build_audit`` and
    ``start_audit_loop``).  ``device="cpu"`` rehearses it (residency
    ``on``)."""
    from gatekeeper_tpu_torch.__main__ import (build_audit,
                                               start_audit_loop,
                                               warm_batcher)
    from gatekeeper_tpu_torch.utils.synthetic import make_cluster_objects
    from gatekeeper_tpu_torch.webhook.namespacelabel import \
        NamespaceLabelHandler
    from gatekeeper_tpu_torch.webhook.policy import (Batcher,
                                                     ValidationHandler)
    from gatekeeper_tpu_torch.webhook.server import WebhookServer

    bodies, objects = admission_traffic(n)
    namespaces = {o["metadata"]["name"]: o for o in objects
                  if o.get("kind") == "Namespace"}
    client, driver, _nt, _nc = _client(objects, device=device)
    cluster_objects = make_cluster_objects(n_objects, seed=9)
    flags = {"device": device, "audit_interval": 0.25,
             "audit_chunk_size": 32768, "audit_source": "snapshot",
             "snapshot_resync_every": 2,
             "snapshot_residency": "auto" if device == "cuda" else "on"}
    # the CLI's own parser, so every flag the entry points read has its
    # default
    from gatekeeper_tpu_torch.__main__ import build_parser

    # the hooks off, as this phase measured the served process before the
    # CLI had them (its gates stay as they were)
    args = build_parser().parse_args(list(HOOKS_OFF))
    vars(args).update(flags)
    mgr, ingester = build_audit(args, cluster_objects, client, driver)
    cluster = ingester.source
    spans = {"audit": [], "audit_tick": [], "audit_resync": []}
    loop_diffs: list = []  # each loop resync's first difference

    def spanned(name):
        fn = getattr(mgr, name)

        def run():
            t0 = time.perf_counter()
            try:
                return fn()
            finally:
                spans[name].append((t0, time.perf_counter()))
                if name == "audit_resync":
                    loop_diffs.append(mgr.last_resync_diff)

        setattr(mgr, name, run)

    for name in spans:
        spanned(name)
    ops = snapshot_churn(cluster_objects, max(8, int(n_objects *
                                                     CHURN_SHARE * 4)),
                         seed=6)
    batcher = Batcher(client).start()
    try:
        warm_batcher(client, batcher)
        server = WebhookServer(
            validation_handler=ValidationHandler(
                client, namespace_lookup=namespaces.get, batcher=batcher,
                failure_policy="fail"),
            namespace_label_handler=NamespaceLabelHandler(),
            host="127.0.0.1", port=0, batcher=batcher).start()
    except BaseException:
        batcher.stop()
        ingester.stop()
        raise
    auditor = start_audit_loop(mgr)
    stop_churn = threading.Event()

    def churn():
        for op, obj in ops:
            if stop_churn.wait(0.005):
                return
            (cluster.apply if op == "apply" else cluster.delete)(obj)

    churner = threading.Thread(target=churn, name="churn", daemon=True)
    try:
        deadline = time.monotonic() + 300
        while not spans["audit"]:  # the loop's first pass builds
            if time.monotonic() > deadline or not auditor.is_alive():
                raise AssertionError("served: the audit loop's first pass "
                                     "never ended")
            time.sleep(0.05)
        churner.start()
        t_burst = time.perf_counter()
        replies, lat, wall = post_concurrently(server.port, bodies)
        t_end = time.perf_counter()
    finally:
        stop_churn.set()
        if churner.is_alive():
            churner.join()
        mgr.stop()
        drained = server.stop()
        auditor.join(timeout=600)
        batcher.stop()
    try:
        if auditor.is_alive():
            raise AssertionError("served: the audit loop did not stop")
        during = {name: sum(1 for a, b in sp if a < t_end and b > t_burst)
                  for name, sp in spans.items()}
        mgr.audit_tick()  # what the loop had not pumped yet
        mgr.audit_resync()
        final_diff = mgr.last_resync_diff
        snap, residency = mgr.snapshot, mgr.residency
        lowered = [st for st in snap.routed_stores() if st.lowered]
        promoted = sum(residency.is_resident(st) for st in lowered)
        host_chunks = mgr.perf.get("snapshot_host_chunks", 0.0)
    finally:
        ingester.stop()
    vocab = driver.vocab
    bijection = len(vocab._to_id) == len(vocab._to_str) and all(
        vocab._to_id[st] == i for i, st in enumerate(vocab._to_str))
    lat_ms = sorted(x * 1e3 for x in lat)
    out = {"admissions": n, "wall_s": wall, "admissions_per_s": n / wall,
           "p50_ms": lat_ms[len(lat_ms) // 2],
           "p99_ms": lat_ms[min(len(lat_ms) - 1,
                                int(0.99 * len(lat_ms)))],
           "passes_during_burst": during, "churn_operations": len(ops),
           "loop_resync_diffs": [d for d in loop_diffs if d],
           "vocab": len(vocab)}
    log(f"served: {n} admissions in {wall:.3f}s, "
        f"{out['admissions_per_s']:.1f} admissions/s, p50 "
        f"{out['p50_ms']:.3f} ms, p99 {out['p99_ms']:.3f} ms beside the "
        f"audit loop over {n_objects} objects ({len(ops)} churn "
        f"operations); passes during the burst {during}, in all "
        f"{ {k: len(v) for k, v in spans.items()} }; loop resync "
        f"differences {out['loop_resync_diffs']}; final resync diff "
        f"{final_diff}; {promoted} of {len(lowered)} lowered groups "
        f"resident, {host_chunks:.0f} host-column chunks; vocab "
        f"{len(vocab)} strings, bijection {bijection} ({card})")
    _denied, code500 = _held_against_cpu("served", objects, namespaces,
                                         bodies, replies)
    if not during["audit_tick"] or not during["audit_resync"]:
        raise AssertionError(f"served: the audit loop did not tick and "
                             f"resync during the burst: {during}")
    if any("vocab" in d for d in out["loop_resync_diffs"]):
        raise AssertionError(f"served: a resync took an admission's "
                             f"strings for its own: "
                             f"{out['loop_resync_diffs']}")
    if final_diff is not None or not bijection or code500 or not drained:
        raise AssertionError(f"served: final resync {final_diff}, vocab "
                             f"bijection {bijection}, {code500} code-500 "
                             f"answers, drained {drained}")
    if promoted != len(lowered) or not lowered or host_chunks:
        raise AssertionError("served: a group served host columns")
    return out


# --- mutation and expansion (the mutate and expand phases) -----------------

# the reference's ExpansionTemplate from Gatekeeper's "Validation of
# Workload Resources" docs: a Deployment implies the Pod of its template
EXPAND_DEPLOYMENTS = {
    "apiVersion": "expansion.gatekeeper.sh/v1alpha1",
    "kind": "ExpansionTemplate",
    "metadata": {"name": "expand-deployments"},
    "spec": {"applyTo": [{"groups": ["apps"], "versions": ["v1"],
                          "kinds": ["Deployment"]}],
             "templateSource": "spec.template",
             "generatedGVK": {"group": "", "version": "v1",
                              "kind": "Pod"}},
}
IMPLIED = "[Implied by expand-deployments]"
PREFILTER_BURSTS = (64, 4096)  # bursts the prefilter's two routes are timed at


def _assign(name, location, value, extra=None) -> dict:
    params = {"assign": {"value": value}}
    params.update(extra or {})
    return {"apiVersion": "mutations.gatekeeper.sh/v1", "kind": "Assign",
            "metadata": {"name": name},
            "spec": {"applyTo": [{"groups": [""], "versions": ["v1"],
                                  "kinds": ["Pod"]}],
                     "location": location, "parameters": params}}


def _assign_meta(name, location, value) -> dict:
    return {"apiVersion": "mutations.gatekeeper.sh/v1beta1",
            "kind": "AssignMetadata", "metadata": {"name": name},
            "spec": {"location": location,
                     "parameters": {"assign": {"value": value}}}}


def mutators() -> list:
    """The 8-mutator registry of the JAX package's mutation bench: 6 the
    prefilter lowers (first), 2 host-only (ModifySet, assignIf)."""
    return [
        _assign("pull-policy", "spec.containers[name: *].imagePullPolicy",
                "Always"),
        _assign("host-network", "spec.hostNetwork", False),
        _assign("run-as-nonroot", "spec.securityContext.runAsNonRoot",
                True),
        _assign("priority", "spec.priority", 100),
        _assign_meta("owner-label", "metadata.labels.owner",
                     "platform-team"),
        _assign_meta("audit-ann", "metadata.annotations.audited", "true"),
        {"apiVersion": "mutations.gatekeeper.sh/v1", "kind": "ModifySet",
         "metadata": {"name": "topo-keys"},
         "spec": {"applyTo": [{"groups": [""], "versions": ["v1"],
                               "kinds": ["Service"]}],
                  "location": "spec.topologyKeys",
                  "parameters": {"operation": "merge",
                                 "values": {"fromList": ["zone"]}}}},
        _assign("dns-policy-cond", "spec.dnsPolicy", "ClusterFirst",
                extra={"assignIf": {"in": ["Default"]}}),
    ]


def mutation_systems(registry=None) -> tuple:
    """(MutationSystem, ExpansionSystem) as the CLI loads them from
    manifests: ``registry`` (default: the whole bench registry) and
    ``expand-deployments``."""
    from gatekeeper_tpu_torch.__main__ import build_mutation

    return build_mutation((mutators() if registry is None else registry)
                          + [EXPAND_DEPLOYMENTS])


def _fold_counted(fn, launches: dict, shapes: dict):
    """``fn`` wrapped so the fold kernels' launches and shapes inside its
    calls add up in ``launches``/``shapes`` (the counters are set to 0
    just before each call and read just after)."""
    from gatekeeper_tpu_torch.ops import fold

    def counted(*args, **kwargs):
        for name in launches:
            getattr(fold, name).launches = 0
            getattr(fold, name).shapes.clear()
        try:
            return fn(*args, **kwargs)
        finally:
            for name in launches:
                launches[name] += getattr(fold, name).launches
                shapes[name].update(getattr(fold, name).shapes)

    return counted


def expand_manager(objects, device: str, collect: str, launches=None,
                   shapes=None, source: str = "relist") -> tuple:
    """(manager, cluster, ingester): the library audit of ``objects`` with
    the generator stage on (``--audit-expand``) and the path phase's
    settings, relisting or (``source="snapshot"``) over a resident snapshot
    fed by a ``FakeCluster`` watch (cluster and ingester None otherwise).
    ``launches``/``shapes`` receive the fold kernels' launches inside the
    generator stage."""
    from gatekeeper_tpu_torch.audit.manager import AuditConfig, AuditManager
    from gatekeeper_tpu_torch.parallel.sweep import SweepEvaluator

    client, driver, _nt, _nc = _client(objects, device=device)
    evaluator = SweepEvaluator(driver, device=device, violations_limit=20,
                               collect=collect)
    _ms, es = mutation_systems()
    config = AuditConfig(violations_limit=20, chunk_size=32768,
                         exact_totals=False, submit_window=4,
                         expand_generated=True, audit_source=source)
    kw, cluster, ingester = {}, None, None
    lister = (lambda: iter(objects))
    if source == "snapshot":
        from gatekeeper_tpu_torch.snapshot import (ClusterSnapshot,
                                                   DeviceResidency,
                                                   SnapshotConfig,
                                                   WatchIngester, gvks_of)
        from gatekeeper_tpu_torch.sync.source import FakeCluster

        cluster = FakeCluster()
        for o in objects:
            cluster.apply(o)
        snap = ClusterSnapshot(evaluator, SnapshotConfig())
        ingester = WatchIngester(snap, cluster,
                                 gvks_of(cluster.list())).start()
        kw = {"snapshot": snap,
              "residency": DeviceResidency(evaluator, mode="auto")}
        lister = cluster.list
    mgr = AuditManager(client, lister=lister, config=config,
                       evaluator=evaluator, expansion_system=es, **kw)
    if launches is not None:
        for name in ("_sweep_generated", "_snapshot_generated"):
            setattr(mgr, name, _fold_counted(getattr(mgr, name), launches,
                                             shapes))
    return mgr, cluster, ingester


def _expand_step(label: str, mgr, fn, device: str, card: str) -> tuple:
    """(run, record) of one audit pass ``fn`` with the generator stage:
    wall, objects, violations, and the generator stage's own counts and
    seconds in this pass."""
    keys = ("generators", "resultants", "expand", "generated_sweep")
    perf0 = {k: mgr.perf.get(k, 0.0) for k in keys}
    t0 = time.perf_counter()
    run = fn()
    if device == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rec = {"wall_s": wall, "objects": run.total_objects,
           "violations": sum(run.total_violations.values()),
           **{k: mgr.perf.get(k, 0.0) - perf0[k] for k in keys}}
    log(f"expand[{label}]: {rec['objects']} objects, {rec['violations']} "
        f"violations, {wall:.3f}s; {rec['generators']:.0f} generators, "
        f"{rec['resultants']:.0f} resultants; expand {rec['expand']:.3f}s, "
        f"generated sweep {rec['generated_sweep']:.3f}s ({card})")
    if run.incomplete:
        raise AssertionError(f"expand[{label}]: incomplete run")
    _schedule_held(f"expand[{label}]", mgr.perf)
    return run, rec


def expand_audit(objects, device: str):
    """One relist audit (its ``AuditRun``) with the generator stage, on
    the reduced lane."""
    mgr = expand_manager(objects, device, "reduced")[0]
    return mgr.audit()


def expand_phase(objects, plain_totals: dict, card: str,
                 device: str = "cuda") -> tuple:
    """``--audit-expand`` over the path phase's objects on both collect
    lanes (relist), then a resident-snapshot first pass and a 1% churn
    tick.  Returns (launches, shapes) of the fold kernels inside the
    generator stage, and the steps' records.  ``device="cpu"`` rehearses
    it (no launches to count, no card-against-CPU comparison)."""
    from gatekeeper_tpu_torch.audit.manager import AuditManager

    launches = {"fused_fold": 0, "epilogue": 0}
    shapes = {name: collections.Counter() for name in launches}
    steps, runs = {}, {}
    for collect, kernel in (("reduced", "fused_fold"),
                            ("masks", "epilogue")):
        before = dict(launches)
        mgr = expand_manager(objects, device, collect, launches, shapes)[0]
        run, steps[collect] = _expand_step(collect, mgr, mgr.audit, device,
                                           card)
        if device == "cuda" and launches[kernel] <= before[kernel]:
            raise AssertionError(f"expand[{collect}]: the generated chunks "
                                 f"never launched {kernel}")
        extra = {k: v - plain_totals[collect].get(k, 0)
                 for k, v in run.total_violations.items()}
        if min(extra.values()) < 0 or sum(extra.values()) <= 0 or \
                not 0 < steps[collect]["resultants"] \
                == steps[collect]["generators"]:
            raise AssertionError(f"expand[{collect}]: the implied Pods "
                                 f"added no violations: {extra}")
        steps[collect]["added_violations"] = sum(extra.values())
        runs[collect] = run
    if summary(runs["reduced"]) != summary(runs["masks"]):
        raise AssertionError("expand: reduced and masks lanes disagree")
    # the resident snapshot with the generator stage: a first pass, then a
    # 1% churn tick
    mgr, cluster, ingester = expand_manager(objects, device, "reduced",
                                            launches, shapes, "snapshot")
    try:
        run1, steps["snapshot first pass"] = _expand_step(
            "snapshot first pass", mgr, mgr.audit, device, card)
        diff = AuditManager._verdicts_differ_canonical(
            run1.kept, run1.total_violations, runs["reduced"].kept,
            runs["reduced"].total_violations, 20)
        if diff is not None:
            raise AssertionError(f"expand: the snapshot differs from the "
                                 f"relist: {diff}")
        implied = sum(v.message.startswith(IMPLIED)
                      for per_con in mgr._gen_verdicts.values()
                      for _count, vs in per_con.values() for v in vs)
        if not implied:
            raise AssertionError(f"expand: no {IMPLIED} violations")
        ops = snapshot_churn(objects, max(8, int(len(objects)
                                                 * CHURN_SHARE)), seed=11)
        _churn_apply(cluster, ops)
        ingester.pump()
        _run2, steps["snapshot churn tick"] = _expand_step(
            f"snapshot churn tick ({len(ops)} operations)", mgr,
            mgr.audit_tick, device, card)
        rows = mgr.perf.get("last_rows_evaluated", 0.0)
        if not 0 < rows <= len(ops):
            raise AssertionError(f"expand: the churn tick evaluated {rows} "
                                 f"rows for {len(ops)} operations")
        steps["snapshot first pass"]["implied_violations"] = implied
        log(f"expand: snapshot == relist canonically; {implied} {IMPLIED} "
            f"violations in the generated verdicts; churn tick {rows:.0f} "
            f"rows")
    finally:
        ingester.stop()
    if device == "cuda":
        prefix = objects[:CPU_PREFIX]
        on_card = summary(expand_audit(prefix, "cuda"))
        on_cpu = summary(expand_audit(prefix, "cpu"))
        if on_card != on_cpu:
            raise AssertionError("expand: the CPU run differs from the "
                                 "card's")
        log(f"expand: cpu == cuda on the first {CPU_PREFIX} objects "
            f"({sum(on_cpu[1].values())} violations)")
    log(f"expand: generator-stage launches {launches}, shapes "
        f"{dict((k, dict(v)) for k, v in shapes.items())}")
    return launches, {k: dict(v) for k, v in shapes.items()}, steps


def _prefilter_times(objs, device: str) -> dict:
    """Wall ms of the lane's relevance rows for one burst through each
    route of the prefilter: the compiled programs on the card
    (``CompiledProgram.run``: upload, torch ops, fetch) and the host numpy
    ``_np_eval``, over one shared flatten; the two must agree."""
    from gatekeeper_tpu_torch.mutation.device import (MutationPrefilter,
                                                      _np_eval)

    ms, _es = mutation_systems(mutators()[:6])
    pre = MutationPrefilter(device=device)
    low = [m for m in ms.active() if pre.add_mutator(m)]
    n = len(objs)
    _rel, batch = pre.relevance_and_batch(low, objs)
    progs = [pre._programs[m.id][2] for m in low]
    out = {}
    for route, fn in (
            ("device", lambda: [pre._run_program(p, batch, n)
                                for p in progs]),
            ("np_eval", lambda: [np.broadcast_to(np.asarray(_np_eval(
                p.program.expr, batch, n), bool), (n,)) for p in progs])):
        rows = fn()
        times = []
        for _ in range(7):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        out[route] = (statistics.median(times), rows)
    for a, b in zip(out["device"][1], out["np_eval"][1]):
        if not np.array_equal(a, b):
            raise AssertionError("prefilter: the card's rows differ from "
                                 "_np_eval's")
    return {"device_ms": out["device"][0], "np_eval_ms": out["np_eval"][0],
            "programs": len(progs)}


def mutate_phase(n: int, card: str, device: str = "cuda") -> dict:
    """``/v1/mutate`` (the batched lane behind its microbatcher) served on
    ``device``, every answer held against the port's per-object CPU
    handler; then ``mutate_batch`` on the card against per-object
    ``mutate`` and the prefilter's two routes timed.  (``/v1/admit`` with
    the expansion system is the admission phase's.)"""
    from gatekeeper_tpu_torch.mutlane import (BatchedMutationHandler,
                                              MutationBatcher, MutationLane)
    from gatekeeper_tpu_torch.webhook.mutation import MutationHandler
    from gatekeeper_tpu_torch.webhook.server import (WebhookServer,
                                                     admission_response)

    bodies, objects = admission_traffic(n)
    namespaces = {o["metadata"]["name"]: o for o in objects
                  if o.get("kind") == "Namespace"}
    ms, _es = mutation_systems()
    lane = MutationLane(ms, device=device)
    lanes: collections.Counter = collections.Counter()
    bursts: collections.Counter = collections.Counter()
    mutate_objects = lane.mutate_objects

    def counted_mutate(objs, **kwargs):
        out = mutate_objects(objs, **kwargs)
        lanes.update(o.lane for o in out)
        bursts[len(objs)] += 1
        return out

    lane.mutate_objects = counted_mutate
    mbatcher = MutationBatcher(lane).start()
    server = WebhookServer(
        mutation_handler=BatchedMutationHandler(
            ms, lane=lane, namespace_lookup=namespaces.get,
            batcher=mbatcher),
        host="127.0.0.1", port=0, mutation_batcher=mbatcher).start()
    try:
        m_replies, m_lat, m_wall = post_concurrently(server.port, bodies,
                                                     "/v1/mutate")
    finally:
        drained = server.stop()
    out = {"mutations": n, "wall_s": m_wall, "mutations_per_s": n / m_wall,
           "lanes": dict(lanes),
           "batch_sizes": dict(sorted(bursts.items()))}
    lat_ms = sorted(x * 1e3 for x in m_lat)
    out["p50_ms"] = lat_ms[len(lat_ms) // 2]
    out["p99_ms"] = lat_ms[min(len(lat_ms) - 1, int(0.99 * len(lat_ms)))]
    log(f"mutate: {n} mutations in {m_wall:.3f}s, "
        f"{out['mutations_per_s']:.1f} mutations/s, p50 "
        f"{out['p50_ms']:.3f} ms, p99 {out['p99_ms']:.3f} ms "
        f"({LOAD_PROCS * LOAD_CONNS} keep-alive clients), {card}")
    log(f"mutate: outcome lanes {dict(lanes)}, lane bursts "
        f"{out['batch_sizes']}")
    # every /v1/mutate answer against the per-object CPU handler
    ref_ms = mutation_systems()[0]
    ref = MutationHandler(ref_ms, namespace_lookup=namespaces.get)
    diffs, patched, errors = [], 0, 0
    for i, body in enumerate(bodies):
        m = ref.handle(copy.deepcopy(body))
        want = admission_response(m.uid, m.allowed, m.message, m.code,
                                  warnings=m.warnings,
                                  patch=m.patch)["response"]
        patched += "patch" in want
        errors += bool(m.message)
        if m_replies[i] != want:
            diffs.append((i, m_replies[i], want))
    log(f"mutate: {patched} patched, {errors} with a mutation error, "
        f"{len(diffs)} differ from the CPU MutationHandler")
    if diffs or not patched or not drained:
        raise AssertionError(f"mutate: answers differ from the CPU handler "
                             f"(first: {diffs[:2]}), or the server did not "
                             f"drain ({drained})")
    # mutate_batch on the card: an all-lowered registry takes the grids
    low_ms, _ = mutation_systems(mutators()[:6])
    objs = [b["request"]["object"] for b in bodies
            if b["request"].get("object") is not None]
    card_objs, ref_objs = copy.deepcopy(objs), copy.deepcopy(objs)
    t0 = time.perf_counter()
    changed = low_ms.mutate_batch(card_objs, device=device)
    batch_s = time.perf_counter() - t0
    want = [low_ms.mutate(o) for o in ref_objs]
    pre = low_ms._prefilter
    log(f"mutate_batch on {device}: {len(objs)} objects, {sum(changed)} "
        f"changed, {batch_s:.3f}s; prefilter rows {pre.perf}")
    if changed != want or card_objs != ref_objs:
        raise AssertionError("mutate_batch on the card differs from "
                             "per-object mutate")
    if pre.perf["program_rows"] <= 0:
        raise AssertionError("mutate_batch: no compiled-program row ran")
    out["mutate_batch_s"] = batch_s
    out["prefilter"] = {}
    for burst in PREFILTER_BURSTS:
        rec = _prefilter_times(objs[:burst], device)
        out["prefilter"][burst] = rec
        log(f"prefilter at burst {burst}: {rec['programs']} relevance "
            f"programs, card (CompiledProgram.run) {rec['device_ms']:.3f} "
            f"ms, host _np_eval {rec['np_eval_ms']:.3f} ms (wall, median of "
            f"7), {card}")
    out["ingest"] = {burst: mutate_ingest(ms, objs[:burst], device, card)
                     for burst in PREFILTER_BURSTS}
    return out


def mutate_ingest(ms, objs, device: str, card: str) -> dict:
    """One burst through ``MutationLane`` under each ingest lane on
    ``device`` (``--mutate-ingest``: the dict walker, raw bytes, and
    raw-then-dict asserted column for column): the outcomes of ``raw``
    and ``differential`` must equal the dict lane's.  Returns each lane's
    wall seconds (one call, after a compile call on 8 objects)."""
    from gatekeeper_tpu_torch.mutlane import MutationLane

    walls, outs = {}, {}
    for ingest in ("dict", "raw", "differential"):
        lane = MutationLane(ms, device=device, ingest=ingest)
        lane.mutate_objects(copy.deepcopy(objs[:8]))
        work = copy.deepcopy(objs)
        t0 = time.perf_counter()
        res = lane.mutate_objects(work, want_objects=True)
        walls[ingest] = time.perf_counter() - t0
        outs[ingest] = [(o.changed, o.patch, o.error, o.obj, o.lane,
                         o.iterations) for o in res]
    log(f"mutate ingest at burst {len(objs)}: " + ", ".join(
        f"{k} {v * 1e3:.3f} ms" for k, v in walls.items())
        + f" (wall, one call), {card}")
    if not outs["raw"] == outs["differential"] == outs["dict"]:
        raise AssertionError(f"mutate ingest at burst {len(objs)}: the raw "
                             f"lanes' outcomes differ from the dict lane's")
    return walls


# --- external data -----------------------------------------------------------
# The reference docs' image-verification setup: two Providers behind an
# in-process stub, the validation template that batches every container
# image into one external_data call, a per-container digest template, and
# the Assign that pins each image through the digest provider.
EXT_RULES_ERRORS = """
package k8sextdata

violation[{"msg": msg}] {
  images := [img | img = input.review.object.spec.containers[_].image]
  response := external_data({"provider": "trusted", "keys": images})
  response_with_error(response)
  msg := sprintf("invalid images: %v", [response.errors])
}

response_with_error(response) {
  count(response.errors) > 0
}

response_with_error(response) {
  count(response.system_error) > 0
}
"""
EXT_RULES_DIGEST = """
package k8sdigest

violation[{"msg": msg}] {
  container := input.review.object.spec.containers[_]
  resp := external_data({"provider": "digest", "keys": [container.image]})
  item := resp.responses[_]
  item[1] != container.image
  msg := sprintf("image %v is not pinned to its digest", [container.image])
}
"""
EXT_TEMPLATES = (("K8sExtData", EXT_RULES_ERRORS),
                 ("K8sDigest", EXT_RULES_DIGEST))
EXT_KINDS = tuple(k for k, _r in EXT_TEMPLATES)
EXT_CONSTRAINTS = [
    {"apiVersion": "constraints.gatekeeper.sh/v1beta1", "kind": kind,
     "metadata": {"name": name},
     "spec": {"match": {"kinds": [{"apiGroups": [""], "kinds": ["Pod"]}]}}}
    for kind, name in (("K8sExtData", "trusted-images"),
                       ("K8sDigest", "pinned-images"))]
EXT_PROVIDERS = [
    {"apiVersion": "externaldata.gatekeeper.sh/v1beta1", "kind": "Provider",
     "metadata": {"name": name},
     "spec": {"url": f"https://{name}.registry.svc:8443/v1/resolve",
              "timeout": 5, "caBundle": "c3R1Yg=="}}
    for name in ("trusted", "digest")]
PIN_IMAGE = {
    "apiVersion": "mutations.gatekeeper.sh/v1",
    "kind": "Assign",
    "metadata": {"name": "pin-image"},
    "spec": {
        "applyTo": [{"groups": [""], "versions": ["v1"], "kinds": ["Pod"]}],
        "location": "spec.containers[name:*].image",
        "parameters": {"assign": {"externalData": {
            "provider": "digest", "dataSource": "ValueAtLocation",
            "failurePolicy": "Ignore"}}},
    },
}
TRUSTED_PREFIX = "openpolicyagent/"  # the library's allowed repo
EXT_MAX_KEYS = 256  # --extdata-max-keys
EXT_SEND_WAIT_S = 0.001  # the stub's fixed wait per transport send
EXT_ADMISSIONS = 512  # admission and mutation bodies (cut from 1,024)


def _ext_template(kind: str, rules: str) -> dict:
    return {"apiVersion": "templates.gatekeeper.sh/v1",
            "kind": "ConstraintTemplate",
            "metadata": {"name": kind.lower()},
            "spec": {"crd": {"spec": {"names": {"kind": kind}}},
                     "targets": [{"target": "admission.k8s.gatekeeper.sh",
                                  "rego": rules}]}}


class RegistryStub:
    """The Providers' transport (``send_fn``), in process: ``trusted``
    answers an error for an image outside ``TRUSTED_PREFIX``, ``digest``
    answers a pinned image itself and ``image@sha256:<crc32>`` otherwise
    (a digest stable across processes).  Each send waits
    ``EXT_SEND_WAIT_S``; sends and keys count per provider."""

    def __init__(self):
        self.lock = threading.Lock()
        self.sends: collections.Counter = collections.Counter()
        self.keys: collections.Counter = collections.Counter()

    def __call__(self, provider, keys):
        with self.lock:
            self.sends[provider.name] += 1
            self.keys[provider.name] += len(keys)
        time.sleep(EXT_SEND_WAIT_S)
        items = []
        for k in keys:
            if provider.name == "trusted":
                items.append({"key": k, "value": k}
                             if k.startswith(TRUSTED_PREFIX)
                             else {"key": k, "error": f"untrusted: {k}"})
            else:
                items.append({"key": k, "value": k if "@sha256:" in k else
                              f"{k}@sha256:{zlib.crc32(k.encode()):08x}"})
        return {"response": {"items": items, "systemError": ""}}

    def counts(self) -> dict:
        with self.lock:
            return {"sends": dict(self.sends), "keys": dict(self.keys)}


def _delta(after: dict, before: dict) -> dict:
    return {k: {p: v - before[k].get(p, 0) for p, v in after[k].items()}
            for k in after}


def extdata_lane(mode: str) -> tuple:
    """(lane, cache, stub): the CLI's provider cache and lane
    (``__main__.build_extdata`` over the two Provider manifests, installed
    for the process) in ``mode``, the transport swapped for the stub."""
    from gatekeeper_tpu_torch.__main__ import build_extdata

    stub = RegistryStub()
    cache, lane = build_extdata(EXT_PROVIDERS, mode=mode,
                                max_keys=EXT_MAX_KEYS)
    cache.send_fn = stub
    return lane, cache, stub


def extdata_expected(objects) -> tuple:
    """({constraint key: violating Pods}, unique image keys), counted in
    plain Python from the objects and the stub's rule."""
    trusted = digest = 0
    keys: set = set()
    for o in objects:
        if o.get("kind") != "Pod" or o.get("apiVersion") != "v1":
            continue
        imgs = [c.get("image") for c in
                (o.get("spec") or {}).get("containers") or []
                if isinstance(c, dict)]
        imgs = [i for i in imgs if isinstance(i, str)]
        keys.update(imgs)
        trusted += any(not i.startswith(TRUSTED_PREFIX) for i in imgs)
        digest += any("@sha256:" not in i for i in imgs)
    return {("K8sExtData", "trusted-images"): trusted,
            ("K8sDigest", "pinned-images"): digest}, keys


def extdata_manager(objects, device: str, collect: str,
                    source: str = "relist", dispatches=None,
                    library: bool = True) -> tuple:
    """(manager, evaluator, residency, ingester): the library (unless
    ``library`` is False) plus both image templates audited through
    ``AuditManager`` with the path phase's settings, relisting or over a
    resident snapshot (``DeviceResidency`` ``auto``; ``on`` when the CPU
    rehearses it).  Without the library the totals are exact (every hit
    rendered and counted), so a kind swept on the grid and the same kind
    on the interpreter count alike; with it they are the grid's
    violating-object counts.  ``dispatches`` receives (kinds, C, padded N)
    of every device dispatch."""
    from gatekeeper_tpu_torch.audit.manager import AuditConfig, AuditManager
    from gatekeeper_tpu_torch.parallel.sweep import SweepEvaluator

    client, driver, _nt, _nc = _client(objects, device=device, extdata=True,
                                       library=library)
    evaluator = SweepEvaluator(driver, device=device, violations_limit=20,
                               collect=collect)
    if dispatches is not None:
        dispatch = evaluator.sweep_dispatch

        def recorded_dispatch(flat):
            if getattr(flat, "kinds", None):
                dispatches.append((flat.kinds, sum(
                    len(flat.by_kind[k]) for k in flat.kinds), flat.pad_n))
            return dispatch(flat)

        evaluator.sweep_dispatch = recorded_dispatch
    config = AuditConfig(violations_limit=20, chunk_size=32768,
                         exact_totals=not library, submit_window=4,
                         audit_source=source)
    if source == "relist":
        return AuditManager(client, lister=lambda: iter(objects),
                            config=config, evaluator=evaluator), \
            evaluator, None, None
    from gatekeeper_tpu_torch.snapshot import (ClusterSnapshot,
                                               DeviceResidency,
                                               SnapshotConfig, WatchIngester,
                                               gvks_of)
    from gatekeeper_tpu_torch.sync.source import FakeCluster

    cluster = FakeCluster()
    for o in objects:
        cluster.apply(o)
    snap = ClusterSnapshot(evaluator, SnapshotConfig())
    ingester = WatchIngester(snap, cluster, gvks_of(cluster.list())).start()
    residency = DeviceResidency(evaluator,
                                mode="auto" if device == "cuda" else "on")
    mgr = AuditManager(client, lister=cluster.list, config=config,
                       evaluator=evaluator, snapshot=snap,
                       residency=residency)
    return mgr, evaluator, residency, ingester


def _canon_diff(a, b):
    from gatekeeper_tpu_torch.audit.manager import AuditManager

    return AuditManager._verdicts_differ_canonical(
        a.kept, a.total_violations, b.kept, b.total_violations, 20)


def extdata_relist(objects, card: str, device: str = "cuda") -> tuple:
    """The relist of ``objects`` with the batched lane on both collect
    lanes (a cold lane each), then a warm repeat on the reduced lane.
    Returns (launches, shapes, records)."""
    from gatekeeper_tpu_torch.ops import fold

    want, keys = extdata_expected(objects)
    bound_per_chunk = -(-len(keys) // EXT_MAX_KEYS)
    launches, shapes, recs, runs = {}, {}, {}, {}
    for collect, kernel in (("reduced", "fused_fold"),
                            ("masks", "epilogue")):
        t_setup = time.perf_counter()
        lane, _cache, stub = extdata_lane("batched")
        dispatches: list = []
        mgr, ev, _r, _i = extdata_manager(objects, device, collect,
                                          dispatches=dispatches)
        setup_s = time.perf_counter() - t_setup
        for wrapper in (fold.fused_fold, fold.epilogue):
            wrapper.launches = 0
            wrapper.shapes.clear()
        t0 = time.perf_counter()
        run = mgr.audit()
        if device == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        _schedule_held(f"extdata[{collect}]", mgr.perf)
        launches[kernel] = getattr(fold, kernel).launches
        shapes[kernel] = dict(getattr(fold, kernel).shapes)
        cold = stub.counts()
        with_ext = sorted({(c, n) for kinds, c, n in dispatches
                           if set(EXT_KINDS) <= set(kinds)})
        n_ext = sum(set(EXT_KINDS) <= set(kinds)
                    for kinds, _c, _n in dispatches)
        got = {k: run.total_violations.get(k) for k in want}
        rec = {"wall_s": wall, "setup_s": setup_s,
               "objects": run.total_objects,
               "violations": sum(run.total_violations.values()),
               "extdata_s": ev.perf.get("extdata", 0.0),
               "launches": launches[kernel], "ext_dispatches": n_ext,
               "ext_shapes": with_ext, "cold": cold,
               "extdata_totals": {f"{k[0]}/{k[1]}": v
                                  for k, v in got.items()},
               "unique_keys": len(keys), "lane_perf": dict(lane.perf)}
        log(f"extdata relist[{collect}]: {run.total_objects} objects, "
            f"{rec['violations']} violations, {wall:.3f}s (set-up "
            f"{setup_s:.3f}s), extdata "
            f"{rec['extdata_s']:.3f}s; {kernel} launches "
            f"{launches[kernel]}, {n_ext} of {len(dispatches)} dispatches "
            f"carry both extdata kinds' rows at (C, N) {with_ext}; cold "
            f"sends {cold['sends']} keys {cold['keys']} for "
            f"{len(keys)} unique keys; totals {rec['extdata_totals']} "
            f"({card})")
        if run.incomplete or n_ext <= 0 or device == "cuda" and (
                launches[kernel] <= 0 or len(dispatches) != launches[kernel]):
            raise AssertionError(f"extdata relist[{collect}]: incomplete, "
                                 f"or the extdata rows rode no {kernel} "
                                 f"launch")
        if got != want:
            raise AssertionError(f"extdata relist[{collect}]: totals {got} "
                                 f"!= {want} counted from the objects")
        for p in ("trusted", "digest"):
            if not 0 < cold["sends"].get(p, 0) <= n_ext * bound_per_chunk \
                    or cold["keys"].get(p) != len(keys):
                raise AssertionError(
                    f"extdata relist[{collect}]: provider {p} took "
                    f"{cold['sends'].get(p)} sends and "
                    f"{cold['keys'].get(p)} keys for {len(keys)} unique "
                    f"keys over {n_ext} chunks")
        if collect == "reduced":
            t0 = time.perf_counter()
            run2 = mgr.audit()
            if device == "cuda":
                torch.cuda.synchronize()
            rec["warm_wall_s"] = time.perf_counter() - t0
            _schedule_held("extdata[warm]", mgr.perf)
            rec["warm"] = _delta(stub.counts(), cold)
            log(f"extdata relist[{collect}] warm repeat: "
                f"{rec['warm_wall_s']:.3f}s, sends {rec['warm']['sends']}")
            if any(rec["warm"]["sends"].values()) or \
                    summary(run2) != summary(run):
                raise AssertionError("extdata: the warm repeat sent keys "
                                     "or changed the result")
        recs[collect] = rec
        runs[collect] = run
    if summary(runs["reduced"]) != summary(runs["masks"]):
        raise AssertionError("extdata: reduced and masks lanes disagree")
    return launches, shapes, recs


def extdata_modes(objects, card: str, device: str = "cuda") -> dict:
    """On the first CPU_PREFIX objects, the two image templates alone with
    exact totals: the batched lane (grid), the perkey lane (interpreter)
    and the differential lane on the card and the batched lane on the CPU
    must agree canonically.  Then with the library: a resident snapshot's
    first pass must equal the batched relist, its Pod group declined by
    the residency (extdata joins keep host columns).  ``device="cpu"``
    rehearses it."""
    prefix = objects[:CPU_PREFIX]
    recs, runs = {}, {}
    for label, mode, dev in (("batched", "batched", device),
                             ("perkey", "perkey", device),
                             ("differential", "differential", device),
                             ("cpu", "batched", "cpu")):
        _lane, _cache, stub = extdata_lane(mode)
        dispatches: list = []
        mgr, _ev, _r, _i = extdata_manager(prefix, dev, "reduced",
                                           dispatches=dispatches,
                                           library=False)
        t0 = time.perf_counter()
        runs[label] = mgr.audit()
        if dev == "cuda":
            torch.cuda.synchronize()
        _schedule_held(f"extdata[{label}]", mgr.perf)
        swept = any(set(EXT_KINDS) & set(kinds)
                    for kinds, _c, _n in dispatches)
        recs[label] = {"wall_s": time.perf_counter() - t0,
                       "ext_on_grid": swept, **stub.counts()}
        log(f"extdata[{label}] at {len(prefix)} objects: "
            f"{recs[label]['wall_s']:.3f}s, extdata kinds on the grid "
            f"{swept}, sends {recs[label]['sends']}, keys "
            f"{recs[label]['keys']}")
        if swept != (mode != "perkey"):
            raise AssertionError(f"extdata[{label}]: the extdata kinds "
                                 f"rode the grid: {swept}")
    for label in ("perkey", "differential", "cpu"):
        diff = _canon_diff(runs[label], runs["batched"])
        if diff is not None:
            raise AssertionError(f"extdata: {label} differs from batched: "
                                 f"{diff}")
    if not all(runs["batched"].total_violations.values()):
        raise AssertionError("extdata: an image constraint has no hit")
    extdata_lane("batched")
    relist_run = extdata_manager(prefix, device, "reduced")[0].audit()
    mgr, _ev, residency, ingester = extdata_manager(prefix, device,
                                                    "reduced", "snapshot")
    try:
        t0 = time.perf_counter()
        snap_run = mgr.audit()
        if device == "cuda":
            torch.cuda.synchronize()
        recs["snapshot"] = {"wall_s": time.perf_counter() - t0,
                            "host_chunks": mgr.perf.get(
                                "snapshot_host_chunks", 0.0),
                            "resident_chunks": mgr.perf.get(
                                "snapshot_resident_chunks", 0.0)}
    finally:
        ingester.stop()
    declined = [r for r in residency._logged_reasons
                if "external-data joins" in r]
    diff = _canon_diff(snap_run, relist_run)
    log(f"extdata: snapshot first pass {recs['snapshot']['wall_s']:.3f}s, "
        f"{recs['snapshot']['host_chunks']:.0f} host-column chunks, "
        f"{recs['snapshot']['resident_chunks']:.0f} resident; residency "
        f"declined: {declined}; == relist: {diff is None}")
    if diff is not None or not declined or \
            not recs["snapshot"]["host_chunks"]:
        raise AssertionError(f"extdata: snapshot first pass differs ({diff})"
                             f" or the residency kept the extdata group")
    log(f"extdata: batched == perkey == differential == cpu at "
        f"{len(prefix)} objects (exact totals "
        f"{dict(runs['batched'].total_violations)}); snapshot == relist "
        f"({sum(snap_run.total_violations.values())} violations with the "
        f"library); per-key {recs['perkey']['sends']} sends "
        f"{recs['perkey']['wall_s']:.3f}s against batched "
        f"{recs['batched']['sends']} sends {recs['batched']['wall_s']:.3f}s "
        f"({card})")
    return recs


def _rate(n: int, lat, wall: float) -> dict:
    lat_ms = sorted(x * 1e3 for x in lat)
    return {"n": n, "wall_s": wall, "per_s": n / wall,
            "p50_ms": lat_ms[len(lat_ms) // 2],
            "p99_ms": lat_ms[min(len(lat_ms) - 1, int(0.99 * len(lat_ms)))]}


def extdata_serve(n_traffic: int, card: str, device: str = "cuda") -> dict:
    """The first EXT_ADMISSIONS admission bodies to ``/v1/admit`` (the
    library plus both image templates, batched lane) and then to
    ``/v1/mutate`` (``pin-image``, batched lane), each answer held against
    the CPU handler under the perkey lane."""
    from gatekeeper_tpu_torch.__main__ import build_mutation, warm_batcher
    from gatekeeper_tpu_torch.mutlane import (BatchedMutationHandler,
                                              MutationBatcher, MutationLane)
    from gatekeeper_tpu_torch.webhook.mutation import MutationHandler
    from gatekeeper_tpu_torch.webhook.policy import (Batcher,
                                                     ValidationHandler)
    from gatekeeper_tpu_torch.webhook.server import (WebhookServer,
                                                     admission_response)

    t_serve = time.perf_counter()

    def mark(what):
        log(f"extdata serve: {what} at {time.perf_counter() - t_serve:.3f}s")

    bodies, objects = admission_traffic(n_traffic)
    bodies, objects = bodies[:EXT_ADMISSIONS], objects[:EXT_ADMISSIONS]
    namespaces = {o["metadata"]["name"]: o for o in objects
                  if o.get("kind") == "Namespace"}
    out = {}
    # /v1/admit
    lane, _cache, stub = extdata_lane("batched")
    client, _driver, _nt, _nc = _client(objects, device=device, extdata=True)
    batcher = Batcher(client).start()
    warm_batcher(client, batcher)
    server = WebhookServer(
        validation_handler=ValidationHandler(
            client, namespace_lookup=namespaces.get, batcher=batcher,
            failure_policy="fail"),
        host="127.0.0.1", port=0, batcher=batcher).start()
    try:
        replies, lat, wall = post_concurrently(server.port, bodies)
    finally:
        drained = server.stop()
    mark("admit served, server stopped")
    out["admit"] = {**_rate(len(bodies), lat, wall), **stub.counts(),
                    "lanes": dict(batcher.lane_counts)}
    ext_denials = sum("[trusted-images]" in (r.get("status") or {}).get(
        "message", "") for r in replies.values())
    log(f"extdata admit: {len(bodies)} admissions in {wall:.3f}s, "
        f"{out['admit']['per_s']:.1f} admissions/s, p50 "
        f"{out['admit']['p50_ms']:.3f} ms, p99 {out['admit']['p99_ms']:.3f}"
        f" ms; lanes {out['admit']['lanes']}; sends {stub.counts()}; "
        f"{ext_denials} denials name trusted-images ({card})")
    extdata_lane("perkey")
    _denied, code500 = _held_against_cpu("extdata admit", objects,
                                         namespaces, bodies, replies,
                                         extdata=True)
    if code500 or not drained or not ext_denials or \
            not out["admit"]["lanes"].get("grid"):
        raise AssertionError("extdata admit: not sane")
    mark("admit held against the CPU")
    # /v1/mutate
    lane, cache, stub = extdata_lane("batched")
    ms = build_mutation([PIN_IMAGE], provider_cache=cache)[0]
    mlane = MutationLane(ms, device=device)
    mbatcher = MutationBatcher(mlane).start()
    server = WebhookServer(
        mutation_handler=BatchedMutationHandler(
            ms, lane=mlane, namespace_lookup=namespaces.get,
            batcher=mbatcher),
        host="127.0.0.1", port=0, mutation_batcher=mbatcher).start()
    try:
        m_replies, m_lat, m_wall = post_concurrently(server.port, bodies,
                                                     "/v1/mutate")
    finally:
        drained = server.stop()
    mark("mutate served, server stopped")
    out["mutate"] = {**_rate(len(bodies), m_lat, m_wall), **stub.counts()}
    _lane, ref_cache, _stub = extdata_lane("perkey")
    ref = MutationHandler(build_mutation([PIN_IMAGE],
                                         provider_cache=ref_cache)[0],
                          namespace_lookup=namespaces.get)
    diffs, patched = [], 0
    for i, body in enumerate(bodies):
        m = ref.handle(copy.deepcopy(body))
        want = admission_response(m.uid, m.allowed, m.message, m.code,
                                  warnings=m.warnings,
                                  patch=m.patch)["response"]
        patched += "patch" in want
        if m_replies[i] != want:
            diffs.append((i, m_replies[i], want))
    log(f"extdata mutate: {len(bodies)} mutations in {m_wall:.3f}s, "
        f"{out['mutate']['per_s']:.1f} mutations/s, p50 "
        f"{out['mutate']['p50_ms']:.3f} ms, p99 "
        f"{out['mutate']['p99_ms']:.3f} ms; {patched} patched, "
        f"{len(diffs)} differ from the CPU MutationHandler (perkey); sends "
        f"{out['mutate']['sends']} ({card})")
    if diffs or not patched or not drained:
        raise AssertionError(f"extdata mutate: answers differ (first: "
                             f"{diffs[:2]}) or no patch or no drain")
    return out


def extdata_phase(objects, n_traffic: int, card: str,
                  device: str = "cuda") -> tuple:
    """External data on the card: the relist on both collect lanes, the
    lane modes and the snapshot at CPU_PREFIX objects, then admission and
    mutation.  Returns (launches, shapes, records).  ``device="cpu"``
    rehearses it (no launches to count)."""
    from gatekeeper_tpu_torch.extdata import lane as extlane

    t0 = time.perf_counter()
    try:
        launches, shapes, recs = extdata_relist(objects, card, device)
        t1 = time.perf_counter()
        recs["modes"] = extdata_modes(objects, card, device)
        t2 = time.perf_counter()
        recs["serve"] = extdata_serve(n_traffic, card, device)
    finally:
        extlane.uninstall()
    t3 = time.perf_counter()
    recs["phase_s"] = {"relist": t1 - t0, "modes": t2 - t1,
                       "serve": t3 - t2, "all": t3 - t0}
    log(f"extdata: phase {t3 - t0:.1f}s (relist {t1 - t0:.1f}s, modes "
        f"{t2 - t1:.1f}s, admit and mutate {t3 - t2:.1f}s)")
    return launches, shapes, recs


# --- the served process's lifecycle -------------------------------------------
# (a): the first LIFE_BODIES admission bodies under template churn, then a
# final burst of LIFE_FINAL; the churn removes and re-adds five Rego
# templates one at a time and edits the message of a sixth
LIFE_BODIES, LIFE_FINAL = 512, 256  # bodies cut from 2,048 (time limit)
# (b)/(d): the snapshot spill and warm restart run on this many of the
# path phase's objects (cut from 131,072, then from 65,536 and 32,768, for
# the time limit)
LIFE_SNAPSHOT_OBJECTS = 16384
LIFE_CHURN_KINDS = ("K8sAllowedRepos", "K8sDisallowedTags",
                    "K8sBlockNodePort", "K8sHttpsOnly", "K8sRequiredProbes")
LIFE_EDIT_KIND = "K8sContainerLimits"
LIFE_EDIT = ("has no memory limit", "lacks a memory limit")
LIFE_CHURN_GAP_S = 0.5  # between two churn operations
LIFE_SWAP_KIND = "K8sRequiredLabels"  # (b): removed across a snapshot tick
LIFE_VERDICT_OBJECTS = 1024  # (c): objects both boots give verdicts on
LIFE_WAIT_S = 300.0
# spill and compile-cache directories: inside the checkout, removed after
LIFE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "_lifecycle")
ROOT_DIR = os.path.dirname(os.path.abspath(__file__))


def _template_kind(doc) -> str:
    return doc["spec"]["crd"]["spec"]["names"]["kind"]


def library_manifests() -> list:
    """The library as ``python -m gatekeeper_tpu_torch --manifests
    library`` loads it: templates, every constraint file, the examples."""
    from gatekeeper_tpu_torch.__main__ import load_manifests
    from gatekeeper_tpu_torch.utils.synthetic import library_dir

    return load_manifests([library_dir()])


def _cli_handler(client, manifests, batcher=None):
    """The validation handler as the CLI's ``serve`` builds it over the
    same manifests (namespaces, process exclusions, expansion)."""
    from gatekeeper_tpu_torch.__main__ import build_mutation, process_excluder
    from gatekeeper_tpu_torch.utils.unstructured import gvk_of, name_of
    from gatekeeper_tpu_torch.webhook.policy import ValidationHandler

    namespaces = {name_of(o): o for o in manifests
                  if gvk_of(o) == ("", "v1", "Namespace")}
    return ValidationHandler(
        client, process_excluder=process_excluder(manifests),
        namespace_lookup=namespaces.get, batcher=batcher,
        failure_policy="fail",
        expansion_system=build_mutation(manifests)[1])


def _label_lines(message: str) -> dict:
    """A deny message as {constraint label: sorted lines}: every line reads
    ``[<constraint name>] <message>``."""
    out: dict = {}
    for line in message.split("\n") if message else ():
        label = line[1:line.index("] ")] if line.startswith("[") \
            and "] " in line else ""
        out.setdefault(label, []).append(line)
    return {k: sorted(v) for k, v in out.items()}


def _labels(manifests, kinds) -> set:
    return {o["metadata"]["name"] for o in manifests
            if o.get("kind") in kinds}


def lifecycle_references(manifests, bodies, edited) -> dict:
    """The CPU handler's answers (exact engines, no batcher) to ``bodies``
    under the library as loaded (``old``), and the deny lines of the edited
    template's constraints under the edited template alone (``edit``):
    the new set's answer is ``old`` with those labels' lines replaced."""
    from gatekeeper_tpu_torch.__main__ import build_client
    from gatekeeper_tpu_torch.webhook.server import admission_response

    t0 = time.perf_counter()
    ref = _cli_handler(build_client(manifests, device="cpu")[0], manifests)
    only = [edited] + [o for o in manifests
                       if o.get("kind") in (LIFE_EDIT_KIND, "Namespace")]
    ed = _cli_handler(build_client(only, device="cpu")[0], manifests)
    old, edit = [], []
    for body in bodies:
        v = ref.handle(copy.deepcopy(body))
        old.append(_answer(admission_response(
            v.uid, v.allowed, v.message, v.code, v.warnings)["response"]))
        edit.append(_label_lines(ed.handle(copy.deepcopy(body)).message))
    churned = _labels(manifests, LIFE_CHURN_KINDS)
    edited_labels = _labels(manifests, (LIFE_EDIT_KIND,))
    others = {o["metadata"]["name"] for o in manifests
              if o.get("apiVersion", "").startswith("constraints.")} \
        - churned - edited_labels
    if churned & others or edited_labels & others or not churned \
            or not edited_labels:
        raise AssertionError("lifecycle: the churned constraints' names "
                             "are not their own")
    changed = sum(e != {k: v for k, v in _label_lines(o[2]).items()
                        if k in edited_labels} for e, o in zip(edit, old))
    log(f"lifecycle: cpu reference handler {time.perf_counter() - t0:.3f}s "
        f"over {len(bodies)} bodies; the edit changes {changed} answers, "
        f"the churned templates' constraints deny "
        f"{sum(bool(set(_label_lines(o[2])) & churned) for o in old)}")
    if not changed:
        raise AssertionError("lifecycle: the edited message never shows")
    return {"old": old, "edit": edit, "churned": churned,
            "edited": edited_labels}


def _new_lines(old_answer, edit_lines, edited) -> dict:
    lines = {k: v for k, v in _label_lines(old_answer[2]).items()
             if k not in edited}
    lines.update(edit_lines)
    return lines


def _answer_fits(got, old_answer, edit_lines, refs, final: bool) -> bool:
    """A served answer against the old and the new template set.  Final:
    exactly the new set's answer.  During the churn: every constraint the
    churn leaves alone answers as in both sets; an edited constraint as in
    the old or the new set; a churned one as in both sets or not at all
    (its template was out at that moment); and the verdict follows the
    lines (no code 500)."""
    allowed, code, message, warnings = got
    g = _label_lines(message)
    o = _label_lines(old_answer[2])
    n = _new_lines(old_answer, edit_lines, refs["edited"])
    if code == 500 or warnings != old_answer[3] or allowed != (not g):
        return False
    if not allowed and code != old_answer[1]:
        return False
    if final:
        return g == n
    for label in set(g) | set(o) | set(n):
        gl = g.get(label)
        if label in refs["churned"]:
            ok = gl is None or gl == o.get(label)
        elif label in refs["edited"]:
            ok = gl == o.get(label) or gl == n.get(label)
        else:
            ok = gl == o.get(label)
        if not ok:
            return False
    return True


def lifecycle_generations(manifests, bodies, refs, edited, swap: bool,
                          card: str, device: str = "cuda") -> dict:
    """(a): the CLI's serving stack on ``device`` over the library with
    ``generation_swap`` on or off; 64 clients post ``bodies`` while a
    thread churns templates through ``Client``; then, once every build is
    done, a final burst."""
    from gatekeeper_tpu_torch.__main__ import build_client, warm_batcher
    from gatekeeper_tpu_torch.webhook.namespacelabel import \
        NamespaceLabelHandler
    from gatekeeper_tpu_torch.webhook.policy import Batcher
    from gatekeeper_tpu_torch.webhook.server import WebhookServer

    label = f"lifecycle[swap {'on' if swap else 'off'}]"
    t0 = time.perf_counter()
    client, driver = build_client(manifests, device=device,
                                  generation_swap=swap)
    boot_s = time.perf_counter() - t0
    coord = driver.gen_coord
    templates = {_template_kind(o): o for o in manifests
                 if o.get("kind") == "ConstraintTemplate"}
    cons = {k: [o for o in manifests if o.get("kind") == k]
            for k in LIFE_CHURN_KINDS}
    batcher = Batcher(client).start()
    op_s: list = []  # each churn call's wall on the churn thread
    errors: list = []

    def readd(kind):
        client.add_template(copy.deepcopy(templates[kind]))
        for c in cons[kind]:
            client.add_constraint(copy.deepcopy(c))

    ops = []
    for kind in LIFE_CHURN_KINDS:
        ops += [lambda k=kind: client.remove_template(k),
                lambda k=kind: readd(k)]
    ops.append(lambda: client.add_template(copy.deepcopy(edited)))

    def churn():
        try:
            time.sleep(2.0)  # the load processes post by now
            for op in ops:
                t = time.perf_counter()
                op()
                op_s.append(time.perf_counter() - t)
                time.sleep(LIFE_CHURN_GAP_S)
        except Exception as e:
            errors.append(repr(e))

    churner = threading.Thread(target=churn, name="template-churn",
                               daemon=True)
    server = None
    try:
        warm_batcher(client, batcher)
        if coord is not None:
            coord.start()
            n_boot = len(coord.compile_seconds)  # the boot's inline builds
        server = WebhookServer(
            validation_handler=_cli_handler(client, manifests, batcher),
            namespace_label_handler=NamespaceLabelHandler(),
            host="127.0.0.1", port=0, batcher=batcher).start()
        churner.start()
        replies, lat, wall = post_concurrently(server.port, bodies)
        churner.join(LIFE_WAIT_S)
        if churner.is_alive() or errors:
            raise AssertionError(f"{label}: the churn did not finish: "
                                 f"{errors}")
        if coord is not None and not coord.wait_idle(LIFE_WAIT_S):
            raise AssertionError(f"{label}: builds still pending")
        final, _flat, _fwall = post_concurrently(server.port,
                                                 bodies[:LIFE_FINAL])
    finally:
        drained = server.stop() if server is not None else False
        batcher.stop()
        if coord is not None:
            coord.stop()
    absent = 0  # answers given while a churned template was out
    bad = []
    for i in range(len(bodies)):
        got, old = _answer(replies[i]), refs["old"][i]
        if not _answer_fits(got, old, refs["edit"][i], refs, final=False):
            bad.append((i, got, old))
        absent += set(_label_lines(old[2])) & refs["churned"] \
            != set(_label_lines(got[2])) & refs["churned"]
    bad_final = [(i, _answer(final[i])) for i in range(len(final))
                 if not _answer_fits(_answer(final[i]), refs["old"][i],
                                     refs["edit"][i], refs, final=True)]
    out = {"swap": swap, "boot_s": boot_s, **_rate(len(bodies), lat, wall),
           "churn_ops": len(op_s), "churn_call_s": op_s,
           "answers_mid_churn": absent, "drained": drained}
    if coord is not None:
        out.update(swaps=coord.swap_count - n_boot,
                   last_error=coord.last_error,
                   warm_errors=coord.warm_errors,
                   last_warm_error=coord.last_warm_error,
                   compile_s=list(coord.compile_seconds)[n_boot:],
                   warm_s=list(coord.warm_seconds),
                   warm_runs=list(coord.warm_runs))
    log(f"{label}: {len(bodies)} admissions in {wall:.3f}s, "
        f"{out['per_s']:.1f} admissions/s, p50 {out['p50_ms']:.3f} ms, p99 "
        f"{out['p99_ms']:.3f} ms during {len(op_s)} template changes "
        f"({LOAD_PROCS * LOAD_CONNS} clients); {absent} answers given with "
        f"a churned template out; boot {boot_s:.3f}s; churn calls "
        f"{[round(x, 3) for x in op_s]} s"
        + (f"; {out['swaps']} background swaps, compile s per generation "
           f"{[round(x, 3) for x in out['compile_s']]}, warm s "
           f"{[round(x, 3) for x in out['warm_s']]}, warm programs (to "
           f"run, ran) {out['warm_runs']}, {coord.warm_errors} warm "
           f"errors (last {coord.last_warm_error}), last_error "
           f"{coord.last_error}" if coord is not None else "")
        + f" ({card})")
    if bad or bad_final:
        raise AssertionError(f"{label}: {len(bad)} answers fit neither "
                             f"template set, {len(bad_final)} final answers "
                             f"differ from the new set; first: "
                             f"{(bad + bad_final)[:2]}")
    if coord is not None and (out["swaps"] < 1 or coord.last_error):
        raise AssertionError(f"{label}: swaps {out['swaps']}, last "
                             f"error {coord.last_error}")
    # every pre-swap warm ran each program its build lowered to its host
    # result, and one of them ran at least one (the edit's)
    if coord is not None and (
            coord.warm_errors or len(out["warm_runs"]) != out["swaps"]
            or any(ran != want for want, ran in out["warm_runs"])
            or not any(ran for _w, ran in out["warm_runs"])):
        raise AssertionError(f"{label}: warms {out['warm_runs']}, "
                             f"{coord.warm_errors} warm errors, last "
                             f"{coord.last_warm_error}")
    if not drained:
        raise AssertionError(f"{label}: the server did not drain")
    return out


def _sync(device: str) -> None:
    if device == "cuda":
        torch.cuda.synchronize()


def _same_verdicts(label: str, a, b) -> None:
    from gatekeeper_tpu_torch.audit.manager import AuditManager

    diff = AuditManager._verdicts_differ_canonical(
        a.kept, a.total_violations, b.kept, b.total_violations, 20)
    if diff is not None or a.total_objects != b.total_objects \
            or a.incomplete or b.incomplete:
        raise AssertionError(f"lifecycle: {label}: {diff} ("
                             f"{a.total_objects} / {b.total_objects} "
                             f"objects)")


def lifecycle_snapshot(objects, card: str, device: str = "cuda") -> dict:
    """(b) and (d): a snapshot first pass spilled in full, loaded into a
    fresh driver and vocab (a hit) and served warm; a delta spill after a
    1% churn; the zlib codec round trip; a corrupt spill rejected and
    rebuilt; then a template removed across a tick (re-chunk, no relist)
    against a fresh relist."""
    from gatekeeper_tpu_torch.apis.constraints import AUDIT_EP
    from gatekeeper_tpu_torch.audit.manager import AuditConfig, AuditManager
    from gatekeeper_tpu_torch.snapshot import (ClusterSnapshot,
                                               SnapshotConfig, SnapshotSpill,
                                               templates_digest)

    mode = "auto" if device == "cuda" else "on"
    roots = {k: os.path.join(LIFE_DIR, k) for k in ("full", "delta", "zlib")}
    out: dict = {}

    def cons_of(mgr):
        return [c for c in mgr.client.constraints()
                if c.actions_for(AUDIT_EP)]

    def save(spill, mgr, ing):
        res = spill.save(mgr.snapshot, rvs=dict(ing.rvs),
                         templates=templates_digest(mgr.client))
        if not res.get("ok"):
            raise AssertionError(f"lifecycle: spill failed: {res}")
        return {"bytes": res["bytes"], "write_s": res["seconds"],
                "capture_s": spill.last_capture_s}

    # A: the first pass, spilled in full
    mgr, _cl, ing, _res, _snap, _ev = snapshot_world(
        objects, device, "reduced", mode)
    try:
        t0 = time.perf_counter()
        first = mgr.audit()
        _sync(device)
        out["step1_s"] = time.perf_counter() - t0
        out["full"] = save(SnapshotSpill(roots["full"]), mgr, ing)
    finally:
        ing.stop()
    del mgr, _cl, ing, _res, _snap, _ev
    gc.collect()

    # B: a fresh driver and vocab loads it and serves warm
    mgr, cluster, ing, res, snap, ev = snapshot_world(
        objects, device, "reduced", mode, generation_swap=True, watch=False)
    coord = ev.driver.gen_coord
    try:
        t0 = time.perf_counter()
        spill = SnapshotSpill(roots["full"])
        loaded = spill.load(snap, cons_of(mgr),
                            templates=templates_digest(mgr.client))
        out["load_s"] = time.perf_counter() - t0
        if loaded is None:
            raise AssertionError(f"lifecycle: the good spill missed: "
                                 f"{spill.stats()['miss_reasons']}")
        ing.from_rvs = dict(loaded["rvs"])
        ing.rvs.update(loaded["rvs"])
        mgr.restore_spill_aux(loaded["aux"])
        # a FakeCluster has no watch cache: the resubscription replays
        # every object, which the no-op detection absorbs
        t1 = time.perf_counter()
        ing.start()
        ing.pump()
        out["replay_s"] = time.perf_counter() - t1
        r0 = mgr.perf.get("snapshot_rows_evaluated", 0.0)
        t1 = time.perf_counter()
        tick = mgr.audit_tick()
        out["warm_tick_s"] = time.perf_counter() - t1
        out["warm_first_s"] = time.perf_counter() - t0
        out["warm_tick_rows"] = mgr.perf["snapshot_rows_evaluated"] - r0
        t1 = time.perf_counter()
        warm = mgr.audit()
        _sync(device)
        out["resident_pass_s"] = time.perf_counter() - t1
        out["warm_s"] = time.perf_counter() - t0
        _same_verdicts("warm tick against the first pass", tick, first)
        _same_verdicts("warm pass against the first pass", warm, first)
        lowered = [s for s in snap.routed_stores() if s.lowered]
        out["uploads"], out["patches"] = res.upload_count, res.patch_count
        if out["warm_tick_rows"] or res.upload_count != len(lowered) \
                or res.patch_count:
            raise AssertionError(f"lifecycle: warm tick evaluated "
                                 f"{out['warm_tick_rows']} rows; "
                                 f"{res.upload_count} uploads, "
                                 f"{res.patch_count} patches for "
                                 f"{len(lowered)} adopted groups")
        # delta: a full delta-mode spill, a 1% churn, a delta spill
        dspill = SnapshotSpill(roots["delta"], delta=True)
        out["delta_full"] = save(dspill, mgr, ing)
        ops = snapshot_churn(objects, max(8, int(len(objects) *
                                                  CHURN_SHARE)), seed=12)
        _churn_apply(cluster, ops)
        ing.pump()
        churned = mgr.audit_tick()
        out["delta"] = save(dspill, mgr, ing)
        # a 1% churn spread over the cluster may dirty every group, and
        # then the delta rewrites them all
        out["delta"]["groups_reused"] = dspill.groups_skipped
        out["delta"]["groups"] = len(snap._groups)
        # zlib: spill, load into another snapshot on the same evaluator
        zspill = SnapshotSpill(roots["zlib"], compress="zlib")
        out["zlib"] = save(zspill, mgr, ing)
        zsnap = ClusterSnapshot(ev, SnapshotConfig())
        t0 = time.perf_counter()
        zl = SnapshotSpill(roots["zlib"]).load(
            zsnap, cons_of(mgr), templates=templates_digest(mgr.client))
        out["zlib"]["load_s"] = time.perf_counter() - t0
        if zl is None:
            raise AssertionError("lifecycle: the zlib spill missed")
        cfg = AuditConfig(violations_limit=20, chunk_size=32768,
                          exact_totals=False, submit_window=4,
                          audit_source="snapshot")
        zmgr = AuditManager(mgr.client, lister=cluster.list, config=cfg,
                            evaluator=ev, snapshot=zsnap)
        _same_verdicts("zlib round trip", zmgr.audit_tick(), churned)
        # corrupt: one flipped byte of a section, then a clean rebuild
        path = os.path.join(roots["zlib"], "snapshot.rows.pkl")
        with open(path, "r+b") as f:
            f.seek(os.path.getsize(path) // 2)
            b = f.read(1)
            f.seek(-1, 1)
            f.write(bytes([b[0] ^ 0xFF]))
        xsnap = ClusterSnapshot(ev, SnapshotConfig())
        xspill = SnapshotSpill(roots["zlib"])
        got = xspill.load(xsnap, cons_of(mgr),
                          templates=templates_digest(mgr.client))
        reasons = xspill.stats()["miss_reasons"]
        left = os.listdir(roots["zlib"])
        xmgr = AuditManager(mgr.client, lister=cluster.list, config=cfg,
                            evaluator=ev, snapshot=xsnap)
        t0 = time.perf_counter()
        rebuilt = xmgr.audit()
        out["corrupt"] = {"miss_reasons": reasons, "left": left,
                          "rebuild_s": time.perf_counter() - t0}
        if got is not None or reasons != {"corrupt": 1} or left:
            raise AssertionError(f"lifecycle: the corrupt spill: hit "
                                 f"{got is not None}, {reasons}, files "
                                 f"left {left}")
        _same_verdicts("rebuild after the corrupt spill", rebuilt, churned)
        del zsnap, zmgr, xsnap, xmgr
        # (b): a template removed across a tick, generation swap on
        lists = [0]
        lister = mgr.lister

        def counted():
            lists[0] += 1
            return lister()

        mgr.lister = counted
        coord.start()
        rechunks, evictions = snap.rechunk_count, res.evictions
        swaps = coord.swap_count
        t0 = time.perf_counter()
        mgr.client.remove_template(LIFE_SWAP_KIND)
        if not coord.wait_idle(LIFE_WAIT_S) or coord.last_error:
            raise AssertionError(f"lifecycle: swap: {coord.last_error}")
        out["swap_build_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        swapped = mgr.audit_tick()
        _sync(device)
        out["swap_tick_s"] = time.perf_counter() - t0
        relist = AuditManager(mgr.client, lister=cluster.list,
                              config=AuditConfig(violations_limit=20,
                                                 chunk_size=32768,
                                                 exact_totals=False,
                                                 submit_window=4),
                              evaluator=ev)
        t0 = time.perf_counter()
        fresh = relist.audit()
        _sync(device)
        out["swap_relist_s"] = time.perf_counter() - t0
        _same_verdicts("tick after the swap against a fresh relist",
                       swapped, fresh)
        out["swap"] = {"swaps": coord.swap_count - swaps,
                       "relists": lists[0],
                       "rechunks": snap.rechunk_count - rechunks,
                       "evictions": res.evictions - evictions}
        if lists[0] or snap.rechunk_count != rechunks + 1 \
                or res.evictions == evictions or out["swap"]["swaps"] < 1 \
                or any(LIFE_SWAP_KIND == k for k, _n in
                       swapped.total_violations):
            raise AssertionError(f"lifecycle: the tick after the swap: "
                                 f"{out['swap']}")
    finally:
        coord.stop()
        ing.stop()
    log(f"lifecycle snapshot: {len(objects)} objects; step 1 (build) "
        f"{out['step1_s']:.3f}s; full spill {out['full']['bytes']} bytes, "
        f"capture {out['full']['capture_s']:.3f}s (audit thread), pickle + "
        f"write {out['full']['write_s']:.3f}s; load {out['load_s']:.3f}s, "
        f"watch replay {out['replay_s']:.3f}s, warm tick "
        f"{out['warm_tick_s']:.3f}s: load + warm first pass "
        f"{out['warm_first_s']:.3f}s against step 1's "
        f"{out['step1_s']:.3f}s; then a resident pass "
        f"{out['resident_pass_s']:.3f}s ({out['uploads']} whole uploads, "
        f"{out['patches']} patches), {out['warm_s']:.3f}s in all; delta spill after {len(ops)} churn "
        f"operations {out['delta']['bytes']} bytes in "
        f"{out['delta']['write_s']:.3f}s ({out['delta']['groups_reused']} of "
        f"{out['delta']['groups']} groups reused) against the full {out['delta_full']['bytes']} "
        f"bytes; zlib {out['zlib']['bytes']} bytes, write "
        f"{out['zlib']['write_s']:.3f}s, load {out['zlib']['load_s']:.3f}s; "
        f"corrupt spill: {out['corrupt']['miss_reasons']}, deleted, rebuilt "
        f"in {out['corrupt']['rebuild_s']:.3f}s; swap: build "
        f"{out['swap_build_s']:.3f}s, tick {out['swap_tick_s']:.3f}s "
        f"{out['swap']}, fresh relist {out['swap_relist_s']:.3f}s ({card})")
    return out


_CACHE_BOOT = r"""
import json, sys, time
t_start = time.perf_counter()
from gatekeeper_tpu_torch.__main__ import build_client, load_manifests
from gatekeeper_tpu_torch.drivers import torch_driver
from gatekeeper_tpu_torch.drivers.generation import CompileCache
calls = []
for name in ("lower_template", "lower_cel_template"):
    real = getattr(torch_driver, name)
    setattr(torch_driver, name,
            lambda *a, _r=real, **k: calls.append(1) or _r(*a, **k))
objects = json.loads(sys.stdin.read())
t0 = time.perf_counter()
cache = CompileCache(sys.argv[2])
client, driver = build_client(load_manifests([sys.argv[1]]),
                              device=sys.argv[3], compile_cache=cache)
boot = time.perf_counter() - t0
from chip_smoke import _keyed_verdicts
print(json.dumps({"boot_s": boot, "import_s": t0 - t_start,
                  "lowered": len(calls), "cache": cache.stats(),
                  "verdicts": _keyed_verdicts(client, driver, objects)}))
"""


def _keyed_verdicts(client, driver, objects) -> list:
    """Per object, the sorted (constraint, message) pairs of one
    ``query_batch`` over every constraint."""
    from gatekeeper_tpu_torch.match.match import SOURCE_ORIGINAL
    from gatekeeper_tpu_torch.target.review import AugmentedUnstructured

    reviews = [client.target.handle_review(AugmentedUnstructured(
        object=copy.deepcopy(o), source=SOURCE_ORIGINAL)) for o in objects]
    cons = sorted(client.constraints(), key=lambda c: c.key())
    out = driver.query_batch(client.target.name, cons, reviews)
    return [sorted([r.constraint["metadata"]["name"], r.msg]
                   for r in qr.results) for qr in out]


def lifecycle_compile_cache(manifests, objects, card: str,
                            device: str = "cuda") -> dict:
    """(c): a cold boot through ``--compile-cache`` lowers every template;
    a fresh process boots from the same directory, lowers none and gives
    the same verdicts on ``objects``."""
    from gatekeeper_tpu_torch.__main__ import build_client
    from gatekeeper_tpu_torch.drivers import torch_driver
    from gatekeeper_tpu_torch.drivers.generation import CompileCache
    from gatekeeper_tpu_torch.utils.synthetic import library_dir

    root = os.path.join(LIFE_DIR, "compile-cache")
    calls: list = []
    real = {n: getattr(torch_driver, n)
            for n in ("lower_template", "lower_cel_template")}
    for name, fn in real.items():
        setattr(torch_driver, name,
                lambda *a, _r=fn, **k: calls.append(1) or _r(*a, **k))
    try:
        t0 = time.perf_counter()
        cache = CompileCache(root)
        client, driver = build_client(manifests, device=device,
                                      compile_cache=cache)
        cold_s = time.perf_counter() - t0
        cold_lowered = len(calls)
        # the same boot again in this process, from the cache
        t0 = time.perf_counter()
        again = CompileCache(root)
        build_client(manifests, device=device, compile_cache=again)
        again_s = time.perf_counter() - t0
    finally:
        for name, fn in real.items():
            setattr(torch_driver, name, fn)
    n_templates = len(client.templates())
    want = _keyed_verdicts(client, driver, objects)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", _CACHE_BOOT, library_dir(), root, device],
        input=json.dumps(objects), capture_output=True, text=True,
        cwd=ROOT_DIR, timeout=LIFE_WAIT_S)
    child_wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"lifecycle: the warm boot process exited "
                             f"{proc.returncode}: {proc.stderr[-3000:]}")
    warm = json.loads(proc.stdout.strip().splitlines()[-1])
    out = {"templates": n_templates, "cold_lowered": cold_lowered,
           "cold_boot_s": cold_s, "cold_stores": cache.stats()["stores"],
           "warm_in_process_s": again_s,
           "warm_in_process_lowered": len(calls) - cold_lowered,
           "warm_lowered": warm["lowered"], "warm_boot_s": warm["boot_s"],
           "warm_import_s": warm["import_s"], "warm_process_s": child_wall,
           "warm_cache": warm["cache"],
           "verdicts": sum(map(len, want))}
    log(f"lifecycle compile cache: cold boot lowered {cold_lowered} of "
        f"{n_templates} templates in {cold_s:.3f}s, the same boot from the "
        f"cache in this process {again_s:.3f}s "
        f"({out['warm_in_process_lowered']} lowered); a fresh process lowered "
        f"{warm['lowered']} and booted in {warm['boot_s']:.3f}s (imports "
        f"{warm['import_s']:.3f}s, process {child_wall:.3f}s), cache "
        f"{warm['cache']}; verdicts on {len(objects)} objects "
        f"({out['verdicts']} hits) {'equal' if warm['verdicts'] == want else 'DIFFER'} "
        f"({card})")
    if cold_lowered != n_templates or out["warm_in_process_lowered"] \
            or warm["lowered"] != 0 \
            or warm["cache"]["hits"] != n_templates \
            or warm["verdicts"] != want or not out["verdicts"]:
        raise AssertionError(f"lifecycle: compile cache: {out}")
    return out


def _cpu_ticks(pid: int) -> int:
    """utime + stime of a process in clock ticks (``/proc/PID/stat``)."""
    with open(f"/proc/{pid}/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    return int(fields[11]) + int(fields[12])


def _alive(pid: int) -> bool:
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def lifecycle_workers(bodies, refs, workers: int, card: str,
                      device: str = "cuda") -> dict:
    """(e): ``python -m gatekeeper_tpu_torch --manifests <library>
    --port P --compile-cache D --webhook-workers W``; the bodies posted
    by 64 clients must each equal the CPU handler, every replica's CPU
    time must rise during the burst, and SIGTERM must end them all."""
    import signal

    from gatekeeper_tpu_torch.utils.synthetic import library_dir

    port = _free_port()
    # the hooks off: the configuration this part measured before the CLI
    # had them (its gates stay as they were)
    cmd = [sys.executable, "-m", "gatekeeper_tpu_torch", "--manifests",
           library_dir(), "--port", str(port), "--compile-cache",
           os.path.join(LIFE_DIR, "compile-cache"), "--webhook-workers",
           str(workers), *HOOKS_OFF]
    if device != "cuda":
        cmd += ["--device", device]
    t_start = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=ROOT_DIR, stderr=subprocess.PIPE,
                            text=True)
    lines: list = []
    serving: dict = {}  # pid -> seconds from the start to serving
    ready = threading.Event()

    def read():
        for line in proc.stderr:
            lines.append(line)
            if "webhook serving on" in line:
                pid = int(line.rsplit("pid ", 1)[1].rstrip(")\n"))
                serving[pid] = time.perf_counter() - t_start
                if len(serving) == workers:
                    ready.set()

    reader = threading.Thread(target=read, daemon=True)
    reader.start()
    pids: list = [proc.pid]
    try:
        if not ready.wait(LIFE_WAIT_S):
            raise AssertionError(f"lifecycle workers={workers}: "
                                 f"{len(serving)} replicas serving after "
                                 f"{LIFE_WAIT_S:.0f}s: {''.join(lines)}")
        pids = sorted(serving)
        if proc.pid not in serving:
            raise AssertionError(f"lifecycle workers={workers}: the parent "
                                 f"did not serve")
        before = {p: _cpu_ticks(p) for p in pids}
        replies, lat, wall = post_concurrently(port, bodies)
        after = {p: _cpu_ticks(p) for p in pids}
        t0 = time.perf_counter()
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=LIFE_WAIT_S)
        stop_s = time.perf_counter() - t0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        for p in pids:
            if p != proc.pid and _alive(p):
                os.kill(p, signal.SIGKILL)
    reader.join(10)
    left = [p for p in pids if _alive(p)]
    bad = [i for i in range(len(bodies))
           if _unordered(_answer(replies[i])) != _unordered(refs["old"][i])]
    out = {"workers": workers, **_rate(len(bodies), lat, wall),
           "boot_s": {str(p): serving[p] for p in pids},
           "cpu_ticks": {str(p): after[p] - before[p] for p in pids},
           "rc": rc, "stop_s": stop_s, "left": left,
           "drained": sum("drain complete" in ln for ln in lines)}
    log(f"lifecycle workers={workers}: {len(bodies)} admissions in "
        f"{wall:.3f}s, {out['per_s']:.1f} admissions/s, p50 "
        f"{out['p50_ms']:.3f} ms, p99 {out['p99_ms']:.3f} ms "
        f"({LOAD_PROCS * LOAD_CONNS} clients); replicas serving after "
        f"{ {p: round(s, 3) for p, s in serving.items()} } s (parent "
        f"{proc.pid}); CPU ticks in the burst {out['cpu_ticks']}; SIGTERM "
        f"-> exit {rc} in {stop_s:.3f}s, {out['drained']} drains, left "
        f"{left}; {len(bad)} answers differ ({card})")
    if bad:
        raise AssertionError(f"lifecycle workers={workers}: answers differ "
                             f"from the CPU handler, first: "
                             f"{[(i, _answer(replies[i])) for i in bad[:2]]}")
    if rc != 0 or left or out["drained"] != workers or \
            min(out["cpu_ticks"].values()) <= 0:
        raise AssertionError(f"lifecycle workers={workers}: {out}; the "
                             f"processes' last lines: {''.join(lines[-40:])}")
    return out


def lifecycle_phase(objects, card: str, device: str = "cuda",
                    n_bodies: int = LIFE_BODIES) -> tuple:
    """The served process's lifecycle, (a)-(e): (launches, shapes,
    record).  Fold launches count from here to the end of the phase (the
    snapshot passes and the relist of (b) and (d) launch them)."""
    import shutil

    from gatekeeper_tpu_torch.ops import fold
    from gatekeeper_tpu_torch.pipeline import effective_cpu_count

    for wrapper in (fold.fused_fold, fold.epilogue):
        wrapper.launches = 0
        wrapper.shapes.clear()
    shutil.rmtree(LIFE_DIR, ignore_errors=True)
    os.makedirs(LIFE_DIR)
    try:
        manifests = library_manifests()
        bodies, _objs = admission_traffic(n_bodies)
        edited = copy.deepcopy(next(
            o for o in manifests if o.get("kind") == "ConstraintTemplate"
            and _template_kind(o) == LIFE_EDIT_KIND))
        target = edited["spec"]["targets"][0]
        if LIFE_EDIT[0] not in target["rego"]:
            raise AssertionError("lifecycle: the edit target moved")
        target["rego"] = target["rego"].replace(*LIFE_EDIT)
        refs = lifecycle_references(manifests, bodies, edited)
        # ABBA: swap on, inline, inline, swap on (order and drift fall
        # equally on both modes)
        record = {"generations": {"on": [], "off": []}}
        for swap in (True, False, False, True):
            record["generations"]["on" if swap else "off"].append(
                lifecycle_generations(manifests, bodies, refs, edited, swap,
                                      card, device))
            gc.collect()
        gens = record["generations"]
        log("lifecycle: churn p99 ms in ABBA order, swap on "
            f"{[round(r['p99_ms'], 3) for r in gens['on']]}, inline "
            f"{[round(r['p99_ms'], 3) for r in gens['off']]}; sums "
            f"{sum(r['p99_ms'] for r in gens['on']):.3f} / "
            f"{sum(r['p99_ms'] for r in gens['off']):.3f} ({card})")
        gc.collect()
        record["snapshot"] = lifecycle_snapshot(
            objects[:LIFE_SNAPSHOT_OBJECTS], card, device)
        gc.collect()
        record["compile_cache"] = lifecycle_compile_cache(
            manifests, objects[:LIFE_VERDICT_OBJECTS], card, device)
        wide = max(1, min(4, effective_cpu_count() // 2))
        record["workers"] = {str(w): lifecycle_workers(
            bodies, refs, w, card, device) for w in sorted({wide, 1},
                                                           reverse=True)}
    finally:
        shutil.rmtree(LIFE_DIR, ignore_errors=True)
    launches = {"fused_fold": fold.fused_fold.launches,
                "epilogue": fold.epilogue.launches}
    shapes = {"fused_fold": dict(fold.fused_fold.shapes),
              "epilogue": dict(fold.epilogue.shapes)}
    log(f"lifecycle: fold launches {launches} at (C, N, k) "
        f"{ {k: sorted(v) for k, v in shapes.items()} }")
    if device == "cuda" and min(launches.values()) <= 0:
        raise AssertionError(f"lifecycle: a fold kernel never launched: "
                             f"{launches}")
    return launches, shapes, record


# --- hooks: the served process's overload limiter, QoS, deadlines, chaos,
# tracing, metrics, cost attribution, flight recorder and SLOs ------------

HOOKS_BODIES = 1024  # (a) and (d): admission bodies per burst
HOOKS_CHUNK = 32768  # (b)-(d): the audit's chunk size, as the path phase's
HOOKS_WALL_NOISE = 1.3  # (a): defaults' ABBA p99 sum against hooks off's
HOOKS_DEADLINE_S = 0.3  # (c): --webhook-deadline of the hang
HOOKS_HANG_S = 2.0  # (c): how long the injected hang holds a review
HOOKS_HANG_BODIES = 256
HOOKS_SLACK_S = 1.0  # (c): an answer's latency past the deadline budget
HOOKS_BURST = (8, 32)  # (d): --overload-max-inflight, --overload-queue-depth
# (d): the audit loop's chunk size, the CLI's --audit-chunk-size default:
# the sweep checks the brownout ladder before each full chunk
HOOKS_BURST_CHUNK = 500
# (d): each burst posts the bodies this many times; a shed answers at once,
# so a burst of the bodies alone is over in ~3 s on the H100's host, while
# the audit thread, starved of the interpreter lock, reached a chunk
# boundary there about once in ~10 s of burst (PERF.md)
HOOKS_BURST_REPEAT = 4
# (d): bursts at most, until the audit has yielded (on a slower H100 host
# the first yield came in the fifth burst, or not within six)
HOOKS_BURST_ROUNDS = 10
# (d): the audit loop's objects, the path's first: cut from 131,072, since
# the phase ends by waiting for the loop's pass in flight (~40 s at the
# full width on the H100's host)
HOOKS_BURST_OBJECTS = 32768
HOOKS_DIR = os.path.join(ROOT_DIR, "_hooks")
SHED_PREFIX = "gatekeeper shed this request under overload ("
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaMemcpy")


def _prom(text: str) -> dict:
    """Prometheus text as {(name, ((label, value), ...)): value}."""
    out = {}
    for line in text.splitlines():
        m = re.match(r"^([A-Za-z_:][\w:]*)(\{[^}]*\})? (\S+)", line)
        if m is None:
            continue
        labels = tuple(sorted(re.findall(r'(\w+)="([^"]*)"',
                                         m.group(2) or "")))
        out[(m.group(1), labels)] = float(m.group(3))
    return out


def _prom_sum(samples: dict, name: str, **match) -> float:
    return sum(v for (n, labels), v in samples.items() if n == name
               and all(dict(labels).get(k) == w for k, w in match.items()))


def _batch_sizes(samples: dict) -> dict:
    """The grid batch-size histogram of ``gatekeeper_webhook_batch_size``:
    batches per bucket (upper bound -> count), their count and mean."""
    name = "gatekeeper_webhook_batch_size"
    cum = sorted(((float(dict(labels)["le"]), v)
                  for (n, labels), v in samples.items()
                  if n == name + "_bucket"), key=lambda lv: lv[0])
    per, prev = {}, 0.0
    for le, v in cum:
        if v > prev:
            per[str(le)] = int(v - prev)
        prev = v
    count = _prom_sum(samples, name + "_count")
    return {"buckets": per, "batches": int(count),
            "mean": _prom_sum(samples, name + "_sum") / count
            if count else 0.0}


def _get(port: int, path: str) -> tuple:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, resp.read().decode()
    finally:
        conn.close()


def _nothing_installed(label: str) -> None:
    """No hook is left installed in this process after a part: a tracer,
    a chaos plan, a controller or a recorder left behind would slow or
    break every later phase."""
    from gatekeeper_tpu_torch.observability import (costattr, flightrec,
                                                    tracing)
    from gatekeeper_tpu_torch.resilience import faults, overload

    left = [name for name, obj in (
        ("tracer", tracing.active_tracer()),
        ("chaos plan", faults.active_plan()),
        ("overload controller", overload.active_controller()),
        ("cost attribution", costattr.active()),
        ("flight recorder", flightrec.active()),
        ("degradations", overload.active_degradations())) if obj is not None]
    if left:
        raise AssertionError(f"hooks[{label}]: left installed: {left}")


def _shed_form(answer: tuple, retry_after) -> bool:
    """The JAX package's shed answer under failurePolicy=Fail: a code-429
    deny that names the reason, with ``Retry-After`` on the HTTP reply."""
    allowed, code, message, _warnings = answer
    return (not allowed and code == 429 and message.startswith(SHED_PREFIX)
            and "(failurePolicy=Fail); retry after" in message
            and retry_after is not None and int(retry_after) >= 1)


def _held_or_shed(label: str, bodies, replies, retry, refs) -> dict:
    """Every answer equals the CPU handler's or is of the shed form; no
    code 500.  Returns the counts."""
    shed = bad = errors = 0
    for i in range(len(bodies)):
        got = _answer(replies[i])
        if got[1] == 500:
            errors += 1
        elif got[1] == 429:
            shed += 1
            bad += not _shed_form(got, retry.get(i))
        else:
            bad += _unordered(got) != _unordered(refs[i])
    if bad or errors:
        raise AssertionError(f"hooks[{label}]: {bad} answers neither the "
                             f"CPU handler's nor of the shed form, {errors} "
                             f"code 500")
    return {"shed": shed, "answered": len(bodies) - shed}


def hooks_cli_run(bodies, refs, hooks_on: bool, card: str,
                  device: str = "cuda") -> dict:
    """(a): ``python -m gatekeeper_tpu_torch --manifests library --port P``
    at the JAX defaults (``hooks_on``) or with ``HOOKS_OFF``; the bodies
    posted by 64 clients.  Every answer equals the CPU handler's or is of
    the shed form, no code 500; the request counters of ``/metrics`` sum
    to the answers; at the defaults ``/debug/{cost,slo,overload}`` and
    ``/debug/decisions?uid=`` answer, hooks off they answer 404."""
    import signal

    from gatekeeper_tpu_torch.utils.synthetic import library_dir

    label = "defaults" if hooks_on else "hooks off"
    port = _free_port()
    cmd = [sys.executable, "-m", "gatekeeper_tpu_torch", "--manifests",
           library_dir(), "--port", str(port)]
    if not hooks_on:
        cmd += list(HOOKS_OFF)
    if device != "cuda":
        cmd += ["--device", device]
    proc = subprocess.Popen(cmd, cwd=ROOT_DIR, stderr=subprocess.PIPE,
                            text=True)
    lines: list = []
    ready = threading.Event()

    def read():
        for line in proc.stderr:
            lines.append(line)
            if "webhook serving on" in line:
                ready.set()

    reader = threading.Thread(target=read, daemon=True)
    reader.start()
    try:
        if not ready.wait(LIFE_WAIT_S):
            raise AssertionError(f"hooks[{label}]: not serving after "
                                 f"{LIFE_WAIT_S:.0f}s: {''.join(lines)}")
        retry: dict = {}
        replies, lat, wall = post_concurrently(port, bodies,
                                               retry_after=retry)
        status, text = _get(port, "/metrics")
        if status != 200:
            raise AssertionError(f"hooks[{label}]: /metrics {status}")
        samples = _prom(text)
        debug = {}
        shed_uids = [bodies[i]["request"]["uid"] for i in range(len(bodies))
                     if _answer(replies[i])[1] == 429]
        uid = (shed_uids or [bodies[0]["request"]["uid"]])[0]
        for path in ("/debug/cost", "/debug/slo", "/debug/overload",
                     f"/debug/decisions?uid={uid}"):
            st, body = _get(port, path)
            debug[path.split("?")[0]] = (st, json.loads(body))
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=LIFE_WAIT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    reader.join(10)
    counts = _held_or_shed(label, bodies, replies, retry, refs)
    counted = _prom_sum(samples, "gatekeeper_validation_request_count")
    shed_counted = _prom_sum(samples, "gatekeeper_validation_request_count",
                             admission_status="shed")
    limit = _prom_sum(samples, "gatekeeper_overload_inflight_limit") \
        if hooks_on else None
    out = {"mode": label, **_rate(len(bodies), lat, wall), **counts,
           "counted": counted, "shed_counted": shed_counted,
           "batches": _batch_sizes(samples), "last_limit": limit,
           "debug_status": {k: v[0] for k, v in debug.items()}, "rc": rc}
    log(f"hooks[{label}]: {len(bodies)} admissions in {wall:.3f}s, "
        f"{out['per_s']:.1f}/s, p50 {out['p50_ms']:.3f} ms, p99 "
        f"{out['p99_ms']:.3f} ms; {counts['shed']} shed; grid batch sizes "
        f"{out['batches']}; limiter's last limit {limit}; request counters "
        f"{counted:.0f} ({shed_counted:.0f} shed); /debug "
        f"{out['debug_status']}; exit {rc} ({card})")
    if rc != 0 or not any("drain complete" in ln for ln in lines):
        raise AssertionError(f"hooks[{label}]: exit {rc}, no drain: "
                             f"{''.join(lines[-40:])}")
    if counted != len(bodies) or shed_counted != counts["shed"]:
        raise AssertionError(f"hooks[{label}]: request counters {counted} "
                             f"({shed_counted} shed) for {len(bodies)} "
                             f"answers ({counts['shed']} shed)")
    if hooks_on:
        cost, slo, ovl, dec = (debug[p][1] for p in (
            "/debug/cost", "/debug/slo", "/debug/overload",
            "/debug/decisions"))
        if set(out["debug_status"].values()) != {200} or not cost["top"] \
                or not slo.get("objectives") \
                or "inflight_limit" not in ovl or not dec["decisions"] \
                or any(d["uid"] != uid for d in dec["decisions"]):
            raise AssertionError(f"hooks[defaults]: debug surface {debug}")
        out["debug"] = {"cost_top": cost["top"][:3], "overload": ovl,
                        "decisions": dec["decisions"][:2],
                        "slo": [(o["name"], o.get("sli"),
                                 o.get("breach")) for o in
                                slo["objectives"]]}
    elif set(out["debug_status"].values()) != {404}:
        raise AssertionError(f"hooks[hooks off]: debug surface answered "
                             f"{out['debug_status']}")
    return out


class _RowsAttribution:
    """Cost attribution that also keeps the rows of every audit dispatch
    attribution in call order (one per chunk)."""

    def __init__(self):
        from gatekeeper_tpu_torch.observability import costattr

        self.attr = costattr.CostAttribution()
        self.rows: list = []
        inner = self.attr.attribute

        def attribute(wall, weights, ep, phase, rows=None):
            if ep == costattr.EP_AUDIT and phase == costattr.PHASE_DISPATCH:
                self.rows.append(dict(rows or {}))
            return inner(wall, weights, ep, phase, rows=rows)

        self.attr.attribute = attribute


def _sync_calls(prof) -> dict:
    """The synchronizing runtime calls the profiler saw on the host."""
    out = dict.fromkeys(SYNC_CALLS, 0)
    for e in prof.key_averages():
        if e.key in out:
            out[e.key] += e.count
    return out


def hooks_relist(mgr, ev, traced: bool, device: str) -> dict:
    """(b): one relist, bare or under a keep-all tracer and cost
    attribution, under ``torch.profiler``; with the tracer the wall time
    of each fold launch (``SweepEvaluator._fold``, which launches one) is
    stamped."""
    from torch.profiler import ProfilerActivity, profile

    from gatekeeper_tpu_torch.observability import costattr, tracing

    chunks = [0]
    dispatch = ev.sweep_dispatch

    def counted(flat):
        chunks[0] += bool(getattr(flat, "kinds", None))
        return dispatch(flat)

    ev.sweep_dispatch = counted
    tracer = cap = None
    stamps: list = []
    if traced:
        tracer = tracing.Tracer(seed=0, ring_capacity=16,
                                max_spans_per_trace=1 << 20)
        cap = _RowsAttribution()
        fold_fn = ev._fold

        def stamped(*args, **kwargs):
            stamps.append(time.time())
            return fold_fn(*args, **kwargs)

        ev._fold = stamped
    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if device == "cuda" else [])
    fallbacks0 = ev.perf.get("collect_fallbacks", 0.0)
    try:
        with profile(activities=activities) as prof:
            if traced:
                with tracing.activate(tracer), costattr.activate(cap.attr):
                    t0 = time.perf_counter()
                    run = mgr.audit()
                    _sync(device)
                    wall = time.perf_counter() - t0
            else:
                t0 = time.perf_counter()
                run = mgr.audit()
                _sync(device)
                wall = time.perf_counter() - t0
    finally:
        del ev.sweep_dispatch  # the class's methods again
        if traced:
            del ev._fold
    out = {"run": run, "wall_s": wall, "chunks": chunks[0],
           "syncs": _sync_calls(prof),
           "fallbacks": ev.perf.get("collect_fallbacks", 0.0) - fallbacks0}
    if traced:
        out.update(tracer=tracer, rows=cap.rows, attr=cap.attr,
                   stamps=stamps)
    return out


def _launches_in_spans(label: str, doc: dict, stamps: list,
                       fallbacks: float) -> int:
    """Each stamped fold launch lies inside a ``device.sweep_dispatch``
    span of the Chrome trace, or (an overflow's masks-lane re-dispatch)
    inside a ``device.sweep_collect`` span.  Returns the launches inside
    dispatch spans."""
    spans = {"device.sweep_dispatch": [], "device.sweep_collect": []}
    for e in doc["traceEvents"]:
        if e.get("ph") == "X" and e["name"] in spans:
            spans[e["name"]].append((e["ts"], e["ts"] + e["dur"]))
    tol_us = 1000.0  # the span's start is the wall clock, its length the
    # perf clock: allow a millisecond between them

    def inside(name, t_us):
        return any(a - tol_us <= t_us <= b + tol_us for a, b in spans[name])

    in_dispatch = sum(inside("device.sweep_dispatch", t * 1e6)
                      for t in stamps)
    in_collect = sum(inside("device.sweep_collect", t * 1e6)
                     and not inside("device.sweep_dispatch", t * 1e6)
                     for t in stamps)
    if in_dispatch + in_collect != len(stamps) or in_collect > fallbacks:
        raise AssertionError(f"hooks[{label}]: {len(stamps)} fold launches, "
                             f"{in_dispatch} inside dispatch spans, "
                             f"{in_collect} inside collect spans for "
                             f"{fallbacks:.0f} overflow re-dispatches")
    return in_dispatch


def hooks_traced(objects, card: str, device: str = "cuda") -> tuple:
    """(b): the relist on both lanes under a keep-all tracer and cost
    attribution against bare relists, ABBA per lane after one warm-up
    relist.  No traced relist may make more synchronizing calls
    (``SYNC_CALLS``) than the bare ones.  Returns (record, the
    reduced lane's bare run, the card client/driver/evaluators, managers)."""
    from gatekeeper_tpu_torch.audit.manager import AuditConfig, AuditManager
    from gatekeeper_tpu_torch.observability import (costattr,
                                                    write_chrome_trace)
    from gatekeeper_tpu_torch.parallel.sweep import SweepEvaluator
    from gatekeeper_tpu_torch.utils.rawjson import as_raw

    client, driver, _nt, _nc = _client(objects, device=device)
    # the raw lane (pre-serialized objects, the C columnizer): the same
    # chunks, spans and verdicts as a dict relist at a third of its wall,
    # for the time limit
    raws = [as_raw(o) for o in objects]
    evs, mgrs = {}, {}
    for lane in ("reduced", "masks"):
        evs[lane] = SweepEvaluator(driver, device=device, violations_limit=20,
                                   collect=lane, flatten_lane="raw")
        mgrs[lane] = AuditManager(
            client, lister=lambda: iter(raws),
            config=AuditConfig(violations_limit=20, chunk_size=HOOKS_CHUNK,
                               exact_totals=False, submit_window=4),
            evaluator=evs[lane])
    record, rows, bare_runs = {}, {}, {}
    os.makedirs(HOOKS_DIR, exist_ok=True)
    for lane in ("reduced", "masks"):
        # warm first (table and parameter caches, hit-buffer sizing): the
        # ABBA runs then all start from a warm evaluator
        mgrs[lane].audit()
        runs = [hooks_relist(mgrs[lane], evs[lane], traced, device)
                for traced in (False, True, True, False)]
        _nothing_installed(f"traced {lane}")
        bare, traced = [runs[0], runs[3]], [runs[1], runs[2]]
        for r in traced:
            _same_verdicts(f"hooks traced[{lane}]", r["run"], bare[1]["run"])
        bare_runs[lane] = bare[1]["run"]
        t = traced[0]
        path = os.path.join(HOOKS_DIR, f"trace-{lane}.json")
        write_chrome_trace(path, t["tracer"])
        with open(path) as f:
            doc = json.load(f)
        names = collections.Counter(
            e["name"] for e in doc["traceEvents"] if e.get("ph") == "X")
        in_dispatch = _launches_in_spans(f"traced {lane}", doc, t["stamps"],
                                         t["fallbacks"])
        spans = [s for tr in t["tracer"].traces() for s in tr["spans"]]
        span_wall = sum(s["duration_s"] for s in spans
                        if s["name"] == "device.sweep_dispatch")
        attributed = t["attr"].total_seconds(costattr.EP_AUDIT,
                                             costattr.PHASE_DISPATCH)
        rows[lane] = t["rows"]
        syncs = {"bare": [r["syncs"] for r in bare],
                 "traced": [r["syncs"] for r in traced]}
        rec = {"walls_s": [r["wall_s"] for r in runs],
               "overhead": (sum(r["wall_s"] for r in traced)
                            / sum(r["wall_s"] for r in bare)),
               "chunks": t["chunks"],
               "dispatch_spans": names["device.sweep_dispatch"],
               "collect_spans": names["device.sweep_collect"],
               "launches_in_dispatch_spans": in_dispatch,
               "launches": len(t["stamps"]), "fallbacks": t["fallbacks"],
               "span_wall_s": span_wall, "attributed_s": attributed,
               "syncs": syncs, "trace_events": len(doc["traceEvents"])}
        record[lane] = rec
        log(f"hooks[traced {lane}]: walls bare/traced/traced/bare "
            f"{[round(w, 3) for w in rec['walls_s']]} s, overhead "
            f"{rec['overhead']:.4f}x; {rec['dispatch_spans']} dispatch spans "
            f"for {rec['chunks']} chunks; {in_dispatch} of {rec['launches']} "
            f"fold launches inside dispatch spans ({t['fallbacks']:.0f} "
            f"overflow re-dispatches); attributed {attributed:.6f} s of "
            f"{span_wall:.6f} s dispatch span wall; sync calls {syncs} "
            f"({card})")
        if rec["dispatch_spans"] != rec["chunks"] or not rec["chunks"]:
            raise AssertionError(f"hooks[traced {lane}]: {rec}")
        if abs(attributed - span_wall) > 0.05 * span_wall:
            raise AssertionError(f"hooks[traced {lane}]: attribution "
                                 f"{attributed} s does not close on the "
                                 f"dispatch spans' {span_wall} s")
        worst = {k: max(s[k] for s in syncs["traced"]) for k in SYNC_CALLS}
        if any(worst[k] > max(s[k] for s in syncs["bare"])
               for k in SYNC_CALLS):
            raise AssertionError(f"hooks[traced {lane}]: the traced relist "
                                 f"synchronized more: {syncs}")
    if rows["reduced"] != rows["masks"] or not rows["reduced"]:
        diff = [i for i, (a, b) in enumerate(zip(rows["reduced"],
                                                 rows["masks"])) if a != b]
        raise AssertionError(f"hooks[traced]: the reduced lane's "
                             f"attribution rows differ from the masks "
                             f"lane's in chunks {diff[:4]} of "
                             f"{len(rows['reduced'])}/{len(rows['masks'])}")
    record["rows_chunks"] = len(rows["reduced"])
    record["rows_total"] = sum(sum(r.values()) for r in rows["reduced"])
    log(f"hooks[traced]: the reduced lane's occ rows equal the masks lane's "
        f"host sums on all {record['rows_chunks']} chunks "
        f"({record['rows_total']} live mask cells) ({card})")
    return record, bare_runs["reduced"], (client, driver, evs, mgrs)


def hooks_chaos(objects, bare_run, world, bodies, refs, card: str,
                device: str = "cuda") -> dict:
    """(c): ``device.dispatch`` errors on the card's relist (one, then more
    than the retries), and a ``webhook.review`` hang under a 0.3 s deadline
    with failurePolicy Ignore."""
    from gatekeeper_tpu_torch.audit.manager import AuditConfig, AuditManager
    from gatekeeper_tpu_torch.resilience import faults
    from gatekeeper_tpu_torch.webhook.policy import (Batcher,
                                                     ValidationHandler)
    from gatekeeper_tpu_torch.webhook.server import WebhookServer

    client, _driver, evs, mgrs = world
    mgr, ev = mgrs["reduced"], evs["reduced"]
    out = {}
    with faults.inject(faults.FaultPlan([{"site": "device.dispatch",
                                          "mode": "error", "times": 1}])):
        run = mgr.audit()
    _nothing_installed("chaos once")
    if summary(run) != summary(bare_run) or run.retried_chunks != 1 \
            or run.failed_chunks or run.incomplete:
        raise AssertionError(f"hooks[chaos once]: retried "
                             f"{run.retried_chunks}, failed "
                             f"{run.failed_chunks}, totals equal "
                             f"{summary(run)[1] == summary(bare_run)[1]}")
    out["once"] = {"retried": run.retried_chunks}
    submitted: list = []
    submit = ev.sweep_submit

    def recorded(cons, objs, *args, **kwargs):
        submitted.append(objs)
        return submit(cons, objs, *args, **kwargs)

    ev.sweep_submit = recorded
    try:
        with faults.inject(faults.FaultPlan([{
                "site": "device.dispatch", "mode": "error", "times": 2,
                "after": 1}])):
            run = mgr.audit()
    finally:
        del ev.sweep_submit  # the class's method again
    _nothing_installed("chaos beyond")
    dropped = list(submitted[1])
    alone = AuditManager(client, lister=lambda: iter(dropped),
                         config=AuditConfig(violations_limit=20,
                                            chunk_size=HOOKS_CHUNK,
                                            exact_totals=False),
                         evaluator=ev).audit()
    want = {k: v - alone.total_violations.get(k, 0)
            for k, v in bare_run.total_violations.items()}
    if not run.incomplete or run.failed_chunks != 1 \
            or run.retried_chunks != 1 or run.total_violations != want:
        raise AssertionError(f"hooks[chaos beyond]: incomplete "
                             f"{run.incomplete}, failed {run.failed_chunks}, "
                             f"retried {run.retried_chunks}, totals equal "
                             f"the others' {run.total_violations == want}")
    out["beyond"] = {"failed": run.failed_chunks,
                     "retried": run.retried_chunks,
                     "dropped_objects": len(dropped),
                     "dropped_violations": sum(
                         alone.total_violations.values())}
    log(f"hooks[chaos]: device.dispatch error once: totals and kept equal "
        f"the bare relist, retried 1; twice past the retries: INCOMPLETE "
        f"({run.failed_chunks} chunk of {len(dropped)} objects dropped, "
        f"{out['beyond']['dropped_violations']} violations), the other "
        f"chunks' totals equal ({card})")
    # the hang: each review's helper thread sleeps HOOKS_HANG_S at the
    # webhook.review site; the answer resolves at the 0.3 s budget
    n = min(HOOKS_HANG_BODIES, len(bodies))
    batcher = Batcher(client).start()
    server = WebhookServer(
        validation_handler=ValidationHandler(
            client, batcher=batcher, failure_policy="ignore",
            deadline_budget_s=HOOKS_DEADLINE_S),
        host="127.0.0.1", port=0, batcher=batcher).start()
    try:
        with faults.inject(faults.FaultPlan([{
                "site": "webhook.review", "mode": "hang",
                "delay_s": HOOKS_HANG_S}])):
            replies, lat, wall = post_concurrently(server.port, bodies[:n])
            time.sleep(HOOKS_HANG_S)  # the last helpers wake and finish
    finally:
        server.stop()
        batcher.stop()
    _nothing_installed("chaos hang")
    late = [x for x in lat if x > HOOKS_DEADLINE_S + HOOKS_SLACK_S]
    bad = [i for i in range(n) if not replies[i]["allowed"]
           or not any("deadline budget" in w
                      for w in replies[i].get("warnings") or [])]
    out["hang"] = {**_rate(n, lat, wall), "late": len(late),
                   "bad": len(bad), "max_ms": max(lat) * 1e3}
    log(f"hooks[chaos hang]: {n} admissions under a {HOOKS_HANG_S:.1f}s "
        f"webhook.review hang, deadline {HOOKS_DEADLINE_S}s, failurePolicy "
        f"Ignore: p50 {out['hang']['p50_ms']:.3f} ms, max "
        f"{out['hang']['max_ms']:.3f} ms, {len(bad)} not allowed with the "
        f"deadline warning, {len(late)} past the budget + "
        f"{HOOKS_SLACK_S}s ({card})")
    if bad or late:
        raise AssertionError(f"hooks[chaos hang]: {out['hang']}")
    return out


def hooks_brownout(objects, bodies, refs, manifests, card: str,
                   device: str = "cuda") -> dict:
    """(d): an overload burst against an 8-slot limiter and a 32-deep
    queue while the relist audit loop runs on the same driver: sheds carry
    ``Retry-After``, no code 500, the brownout ladder reaches level 1 or
    more and the audit yields the device lane (``/debug/overload`` polled,
    the ``device_lane_yield`` counter, the manager's yielded seconds)."""
    from gatekeeper_tpu_torch.__main__ import (build_client, build_mutation,
                                               process_excluder,
                                               start_audit_loop)
    from gatekeeper_tpu_torch.audit.manager import AuditConfig, AuditManager
    from gatekeeper_tpu_torch.metrics import registry as M
    from gatekeeper_tpu_torch.metrics.registry import MetricsRegistry
    from gatekeeper_tpu_torch.parallel.sweep import SweepEvaluator
    from gatekeeper_tpu_torch.resilience import overload
    from gatekeeper_tpu_torch.utils.unstructured import gvk_of, name_of
    from gatekeeper_tpu_torch.webhook.policy import (Batcher,
                                                     ValidationHandler)
    from gatekeeper_tpu_torch.webhook.server import WebhookServer

    reg = MetricsRegistry()
    client, driver = build_client(manifests, device=device, metrics=reg)
    ev = SweepEvaluator(driver, device=device, violations_limit=20,
                        metrics=reg)
    mgr = AuditManager(client, lister=lambda: iter(objects),
                       config=AuditConfig(interval_s=0.05,
                                          violations_limit=20,
                                          chunk_size=HOOKS_BURST_CHUNK,
                                          exact_totals=False),
                       evaluator=ev, metrics=reg)
    ctl = overload.OverloadController(overload.OverloadConfig(
        max_inflight=HOOKS_BURST[0], queue_depth=HOOKS_BURST[1]),
        metrics=reg)
    namespaces = {name_of(o): o for o in manifests
                  if gvk_of(o) == ("", "v1", "Namespace")}
    batcher = Batcher(client, metrics=reg).start()
    server = WebhookServer(
        validation_handler=ValidationHandler(
            client, process_excluder=process_excluder(manifests),
            namespace_lookup=namespaces.get, batcher=batcher,
            failure_policy="fail",
            expansion_system=build_mutation(manifests)[1], metrics=reg,
            overload=ctl),
        host="127.0.0.1", port=0, batcher=batcher, metrics=reg).start()
    levels: list = []
    stop_poll = threading.Event()

    def poll():
        while not stop_poll.wait(0.1):
            try:
                st, body = _get(server.port, "/debug/overload")
            except OSError:  # a poll in flight when the server stops
                continue
            if st == 200:
                levels.append(json.loads(body)["brownout"])

    poller = threading.Thread(target=poll, name="overload-poll",
                              daemon=True)
    with overload.activate(ctl):
        auditor = start_audit_loop(mgr)
        try:
            deadline = time.monotonic() + LIFE_WAIT_S
            while not ev.perf.get("dispatch"):  # the loop's first chunk
                if time.monotonic() > deadline or not auditor.is_alive():
                    raise AssertionError("hooks[brownout]: the audit loop "
                                         "never dispatched")
                time.sleep(0.01)
            poller.start()
            # the sweep checks the ladder before each full chunk, and the
            # burst starves the audit thread of the interpreter lock: burst
            # again (at most HOOKS_BURST_ROUNDS times) until it has yielded
            rounds = []
            burst = bodies * HOOKS_BURST_REPEAT
            burst_refs = refs * HOOKS_BURST_REPEAT
            for _round in range(HOOKS_BURST_ROUNDS):
                retry: dict = {}
                replies, lat, wall = post_concurrently(server.port, burst,
                                                       retry_after=retry)
                rounds.append(_held_or_shed("brownout", burst, replies,
                                            retry, burst_refs))
                if mgr.perf.get("brownout_yield_s", 0.0) > 0:
                    break
        finally:
            stop_poll.set()
            mgr.stop()
            server.stop()
            auditor.join(timeout=LIFE_WAIT_S)
            batcher.stop()
            if poller.is_alive():
                poller.join(10)
    _nothing_installed("brownout")
    if auditor.is_alive():
        raise AssertionError("hooks[brownout]: the audit loop did not stop")
    counts = rounds[-1]
    yielded = mgr.perf.get("brownout_yield_s", 0.0)
    yield_counted = reg.get_counter(M.RESILIENCE_DEGRADED, {
        "component": "audit", "to": "device_lane_yield"})
    out = {**_rate(len(burst), lat, wall), **counts,
           "max_brownout": max(levels, default=0), "rounds": len(rounds),
           "shed_rounds": [r["shed"] for r in rounds],
           "polls": len(levels), "yield_s": yielded,
           "yield_counted": yield_counted, "shed_count": ctl.shed_count}
    log(f"hooks[brownout]: {len(burst)} admissions a burst against "
        f"--overload-max-inflight {HOOKS_BURST[0]} --overload-queue-depth "
        f"{HOOKS_BURST[1]} beside the audit loop ({len(rounds)} bursts): "
        f"{out['per_s']:.1f}/s, p99 {out['p99_ms']:.3f} ms, shed "
        f"{out['shed_rounds']} (Retry-After on each), brownout levels "
        f"polled {collections.Counter(levels)}, the "
        f"audit yielded the device lane {yielded:.3f}s "
        f"({yield_counted:.0f} yields counted) ({card})")
    if not counts["shed"] or out["max_brownout"] < 1 or yielded <= 0 \
            or yield_counted <= 0:
        raise AssertionError(f"hooks[brownout]: {out}")
    return out


def hooks_phase(objects, card: str, device: str = "cuda",
                n_bodies: int = HOOKS_BODIES, after_served=None) -> tuple:
    """The served process's hooks, (a)-(d): (launches, shapes, record).
    Fold launches count from here to the end of the phase ((b)'s and
    (c)'s relists and (d)'s audit loop launch them; (a)'s CLI processes
    are not counted).  ``after_served`` is called once (a)'s ABBA runs
    have held their gate."""
    import shutil

    from gatekeeper_tpu_torch.__main__ import build_client
    from gatekeeper_tpu_torch.ops import fold
    from gatekeeper_tpu_torch.webhook.server import admission_response

    wrappers = {"fused_fold": fold.fused_fold, "epilogue": fold.epilogue}
    for wrapper in wrappers.values():
        wrapper.launches = 0
        wrapper.shapes.clear()
    _nothing_installed("start")
    shutil.rmtree(HOOKS_DIR, ignore_errors=True)
    record = {}
    try:
        manifests = library_manifests()
        bodies, _objs = admission_traffic(n_bodies)
        t0 = time.perf_counter()
        ref = _cli_handler(build_client(manifests, device="cpu")[0],
                           manifests)
        refs = []
        for body in bodies:
            v = ref.handle(copy.deepcopy(body))
            refs.append(_answer(admission_response(
                v.uid, v.allowed, v.message, v.code,
                v.warnings)["response"]))
        log(f"hooks: cpu reference handler {time.perf_counter() - t0:.3f}s "
            f"over {len(bodies)} bodies")
        # (a) ABBA: defaults, hooks off, hooks off, defaults
        runs = {"defaults": [], "off": []}
        for on in (True, False, False, True):
            runs["defaults" if on else "off"].append(
                hooks_cli_run(bodies, refs, on, card, device))
            gc.collect()
        sums = {k: sum(r["p99_ms"] for r in v) for k, v in runs.items()}
        record["served"] = runs
        log(f"hooks[a]: p99 ms in ABBA order, defaults "
            f"{[round(r['p99_ms'], 3) for r in runs['defaults']]}, hooks "
            f"off {[round(r['p99_ms'], 3) for r in runs['off']]}; sums "
            f"{sums['defaults']:.3f} / {sums['off']:.3f} "
            f"({sums['defaults'] / sums['off']:.3f}x, gate "
            f"{HOOKS_WALL_NOISE}x) ({card})")
        if sums["defaults"] > HOOKS_WALL_NOISE * sums["off"]:
            raise AssertionError(f"hooks[a]: the defaults' ABBA p99 sum "
                                 f"{sums['defaults']:.3f} ms exceeds "
                                 f"{HOOKS_WALL_NOISE}x hooks off's "
                                 f"{sums['off']:.3f} ms")
        if after_served is not None:
            after_served()
        # (b) traced relists, (c) chaos, (d) brownout
        record["traced"], bare_run, world = hooks_traced(objects, card,
                                                         device)
        gc.collect()
        record["chaos"] = hooks_chaos(objects, bare_run, world, bodies,
                                      refs, card, device)
        del world
        gc.collect()
        record["brownout"] = hooks_brownout(objects[:HOOKS_BURST_OBJECTS],
                                            bodies, refs, manifests, card,
                                            device)
    finally:
        shutil.rmtree(HOOKS_DIR, ignore_errors=True)
    _nothing_installed("end")
    launches = {n: w.launches for n, w in wrappers.items()}
    shapes = {n: dict(w.shapes) for n, w in wrappers.items()}
    log(f"hooks: fold launches {launches} at (C, N, k) "
        f"{ {k: sorted(v) for k, v in shapes.items()} }")
    if device == "cuda" and min(launches.values()) <= 0:
        raise AssertionError(f"hooks: a fold kernel never launched: "
                             f"{launches}")
    return launches, shapes, record


# --- kube: the served process over an apiserver ------------------------------

KUBE_DIR = os.path.join(ROOT_DIR, "_kube")
# the apiservers' objects: cut from the path's 131,072, then from 65,536,
# 32,768, 16,384 and 8,192, for the time limit (the CLI of (d) audits them
# beside the phases before the kube phase, whose end waits for that first
# exact-totals pass)
KUBE_OBJECTS = 4096
KUBE_BODIES = 512  # (d): admission bodies (cut from 1,024)
KUBE_WAIT_S = 300.0
KUBE_VANISH = 64  # (b): objects removed behind the watches before the 410
KUBE_DATA_KINDS = ("Pod", "Service", "Ingress", "Deployment", "Namespace",
                   "RoleBinding", "ClusterRoleBinding")
STATUS_GROUP = "status.gatekeeper.sh"
# an installed Gatekeeper's Config: the Ingresses synced as the
# referential inventory (uniqueingresshost), as the other phases load them
KUBE_CONFIG = {
    "apiVersion": "config.gatekeeper.sh/v1alpha1", "kind": "Config",
    "metadata": {"name": "config", "namespace": "gatekeeper-system"},
    "spec": {"sync": {"syncOnly": [{"group": "networking.k8s.io",
                                    "version": "v1", "kind": "Ingress"}]}}}
# (d): written to the apiserver after the CLI serves
KUBE_LATE_CONSTRAINT = {
    "apiVersion": "constraints.gatekeeper.sh/v1beta1",
    "kind": "K8sRequiredLabels", "metadata": {"name": "all-must-have-team"},
    "spec": {"match": {"kinds": [{"apiGroups": [""],
                                  "kinds": ["Namespace"]}]},
             "parameters": {"labels": [{"key": "team"}]}}}


def library_policy_docs() -> list:
    """The library's templates and their sample constraints, as
    ``load_library`` installs them."""
    import glob

    from gatekeeper_tpu_torch.utils.synthetic import library_dir
    from gatekeeper_tpu_torch.utils.unstructured import load_yaml_file

    docs = []
    for tpath in sorted(
            glob.glob(os.path.join(library_dir(), "general", "*",
                                   "template.yaml")) +
            glob.glob(os.path.join(library_dir(), "pod-security-policy", "*",
                                   "template.yaml"))):
        docs += load_yaml_file(tpath)[:1]
        cpath = os.path.join(os.path.dirname(tpath), "samples",
                             "constraint.yaml")
        if os.path.exists(cpath):
            docs += load_yaml_file(cpath)
    return docs


def _kube_apiserver(conn, n_objects: int) -> None:
    """The child process of the kube phase: the port's ``MockApiServer``
    holding the library's templates and sample constraints, a Config, and
    ``make_cluster_objects(n_objects, seed=0)``, with a resource for every
    constraint kind and every per-pod status kind (the CRDs an installed
    Gatekeeper has; the mock does not derive resources from CRDs).  It
    builds everything itself, so nothing but commands crosses the pipe,
    and encodes its pages without the audit's interpreter lock.  Commands:
    ``stats`` (requests by verb and kind), ``rv`` (the current
    resourceVersion), ``vanish`` (drop objects without an event; answers
    how many it held),
    ``compact`` (compact the watch cache, break every watch with a 410 and
    write the Config unchanged; answers the version of that write),
    ``stop``."""
    from gatekeeper_tpu_torch.controller.manager import STATUS_KIND_FOR
    from gatekeeper_tpu_torch.sync.mock_apiserver import MockApiServer
    from gatekeeper_tpu_torch.utils.synthetic import make_cluster_objects

    srv = MockApiServer()
    for kind in sorted(set(STATUS_KIND_FOR.values())):
        srv.add_resource(kind, STATUS_GROUP, "v1beta1", kind.lower() + "es",
                         True)
    docs = library_policy_docs()
    for doc in docs:
        if doc["kind"] != "ConstraintTemplate":
            srv.add_resource(doc["kind"], "constraints.gatekeeper.sh",
                             "v1beta1", doc["kind"].lower(), False)
    for doc in docs + [KUBE_CONFIG] + make_cluster_objects(n_objects,
                                                           seed=0):
        srv.put_object(doc)
    srv.start()
    conn.send(("ready", srv.url, len(srv._objects)))
    while True:
        cmd, arg = conn.recv()
        if cmd == "stats":
            conn.send(dict(srv.requests))
        elif cmd == "vanish":
            with srv._lock:
                dropped = sum(srv._objects.pop(tuple(key), None) is not None
                              for key in arg)
                srv._sorted.clear()
            conn.send(dropped)
        elif cmd == "rv":
            conn.send(srv._rv)
        elif cmd == "compact":
            srv.compact()
            for kind in list(srv.resources):
                srv.break_watches(kind)
            # one unchanged write past the compaction: a watch whose mark
            # reaches its version has relisted since
            srv.put_object(dict(srv._objects[("Config", "gatekeeper-system",
                                              "config")]))
            conn.send(srv._rv)
        elif cmd == "stop":
            srv.stop()
            conn.send("stopped")
            return


def _wait(label: str, pred, timeout: float = KUBE_WAIT_S,
          every: float = 0.05) -> float:
    t0 = time.perf_counter()
    while not pred():
        if time.perf_counter() - t0 > timeout:
            raise AssertionError(f"kube: {label}: not within {timeout:.0f}s")
        time.sleep(every)
    return time.perf_counter() - t0


def _caught_up(kc, gvks, rv: int) -> bool:
    """Every watch of ``kc`` over ``gvks`` has handed its consumer every
    event at or below ``rv`` (its resume mark, a list's or a bookmark's
    version, is at least ``rv``): unlike a count of events, blind to
    other writers' events."""
    return all(int(kc.resume_rv(g) or 0) >= rv for g in gvks)


def _lists(before: dict, after: dict, kinds=None) -> int:
    return sum(n - before.get(k, 0) for k, n in after.items()
               if k[0] == "list" and (kinds is None or k[1] in kinds))


def _kube_cluster(url: str, **kw):
    from gatekeeper_tpu_torch.sync.kube import KubeCluster, KubeConfig

    return KubeCluster(KubeConfig(server=url), watch_backoff_s=0.2, **kw)


def kube_relist(client, driver, url, ask, path_verdicts, path_timings,
                card: str, device: str = "cuda") -> dict:
    """(a): ``AuditManager.audit()`` over the CLI's discovery-driven lister
    (``__main__.kube_lister``) of a ``KubeCluster`` with raw pages, on both
    collect lanes: canonically equal to the dict relist's runs, every chunk
    on the raw flatten lane, the lane's fold kernel launched."""
    from gatekeeper_tpu_torch.__main__ import kube_lister
    from gatekeeper_tpu_torch.audit.manager import (AuditConfig,
                                                    AuditManager)
    from gatekeeper_tpu_torch.ops import fold
    from gatekeeper_tpu_torch.parallel.sweep import SweepEvaluator

    out = {}
    for collect, kernel in (("reduced", "fused_fold"),
                            ("masks", "epilogue")):
        kc = _kube_cluster(url)
        page_bytes = [0]
        request_once = kc._request_once

        def counted(method, path, body=None, timeout=30.0, raw=False,
                    request_once=request_once):
            if not raw:
                return request_once(method, path, body, timeout)
            data = request_once(method, path, body, timeout, raw=True)
            page_bytes[0] += len(data)
            return data

        kc._request_once = counted
        ev = SweepEvaluator(driver, device=device, violations_limit=20,
                            collect=collect)
        mgr = AuditManager(client, lister=kube_lister(kc),
                           config=AuditConfig(violations_limit=20,
                                              chunk_size=32768,
                                              exact_totals=False,
                                              submit_window=4),
                           evaluator=ev)
        try:
            launched0 = getattr(fold, kernel).launches
            stats0 = ask("stats")
            t0 = time.perf_counter()
            run = mgr.audit()
            _sync(device)
            wall = time.perf_counter() - t0
            stats1 = ask("stats")
        finally:
            kc.close()
        phases = {**ev.perf, **mgr.perf}
        _schedule_held(f"kube relist[{collect}]", mgr.perf)
        lanes = _lanes(ev.perf)
        launched = getattr(fold, kernel).launches - launched0
        kept, totals = path_verdicts[collect]
        diff = AuditManager._verdicts_differ_canonical(
            run.kept, run.total_violations, kept, totals, 20)
        path_wall, path_phases = path_timings[collect]
        rec = {"wall_s": wall, "objects": run.total_objects,
               "objects_per_s": run.total_objects / wall,
               "list_requests": _lists(stats0, stats1),
               "page_bytes": page_bytes[0], "lanes": lanes,
               "launches": launched,
               **{k: phases.get(k, 0.0) for k in
                  ("flatten", "fl_c_columnize", "upload")},
               "path_wall_s": path_wall,
               **{f"path_{k}": path_phases.get(k, 0.0) for k in
                  ("flatten", "fl_c_columnize", "upload")}}
        out[collect] = rec
        log(f"kube relist[{collect}]: {run.total_objects} objects, "
            f"{sum(run.total_violations.values())} violations, "
            f"{wall:.3f}s, {rec['objects_per_s']:.1f} objects/s, "
            f"{rec['list_requests']} LIST requests, {page_bytes[0]} page "
            f"bytes, flatten {rec['flatten']:.3f}s, c_columnize "
            f"{rec['fl_c_columnize']:.3f}s, upload {rec['upload']:.3f}s, "
            f"lanes {lanes}, {launched} {kernel} launches; the same "
            f"objects' relist (in-memory dict lister) {path_wall:.3f}s, "
            f"flatten {rec['path_flatten']:.3f}s, c_columnize "
            f"{rec['path_fl_c_columnize']:.3f}s, upload "
            f"{rec['path_upload']:.3f}s ({card})")
        if diff is not None or run.incomplete:
            raise AssertionError(f"kube relist[{collect}] differs from the "
                                 f"dict relist: {diff}")
        if set(lanes) != {"raw"}:
            raise AssertionError(f"kube relist[{collect}]: chunks left the "
                                 f"raw lane: {lanes}")
        if device == "cuda" and launched <= 0:
            raise AssertionError(f"kube relist[{collect}]: {kernel} never "
                                 f"launched")
        if rec["list_requests"] <= 0:
            raise AssertionError(f"kube relist[{collect}]: no LIST request")
    return out


def _kube_world(client, driver, url, device, from_rvs=None):
    """The CLI's ``--audit-source snapshot`` stack over a fresh
    ``KubeCluster``: (kube cluster, ingester, snapshot, manager,
    residency); the ingester is not started."""
    from gatekeeper_tpu_torch.__main__ import kube_lister
    from gatekeeper_tpu_torch.audit.manager import (AuditConfig,
                                                    AuditManager)
    from gatekeeper_tpu_torch.parallel.sweep import SweepEvaluator
    from gatekeeper_tpu_torch.snapshot import (ClusterSnapshot,
                                               DeviceResidency,
                                               SnapshotConfig, WatchIngester)

    kc = _kube_cluster(url)
    ev = SweepEvaluator(driver, device=device, violations_limit=20,
                        collect="reduced")
    snap = ClusterSnapshot(ev, SnapshotConfig())
    ing = WatchIngester(snap, kc, kc.server_preferred_gvks(),
                        from_rvs=from_rvs)
    residency = DeviceResidency(ev, mode="auto" if device == "cuda"
                                else "on")
    mgr = AuditManager(client, lister=kube_lister(kc),
                       config=AuditConfig(violations_limit=20,
                                          chunk_size=32768,
                                          exact_totals=False,
                                          submit_window=4,
                                          audit_source="snapshot"),
                       evaluator=ev, snapshot=snap, residency=residency)
    return kc, ing, snap, mgr, residency


def _churn_over_http(writer, ops) -> None:
    """Each operation a PUT (after a POST that finds the object) or a
    POST, or a DELETE, through the apiserver, eight at a time."""
    from concurrent.futures import ThreadPoolExecutor

    def one(op):
        kind, obj = op
        (writer.apply if kind == "apply" else writer.delete)(obj)

    with ThreadPoolExecutor(8) as pool:
        list(pool.map(one, ops))


def _canon_or_raise(label: str, run, kept, totals) -> None:
    from gatekeeper_tpu_torch.audit.manager import AuditManager

    diff = AuditManager._verdicts_differ_canonical(
        run.kept, run.total_violations, kept, totals, 20)
    if diff is not None or run.incomplete:
        raise AssertionError(f"kube snapshot: {label}: {diff}")


def _kube_step(out: dict, label: str, fn, card: str, device: str):
    t0 = time.perf_counter()
    run = fn()
    _sync(device)
    wall = time.perf_counter() - t0
    out[label] = {"wall_s": wall, "objects": run.total_objects,
                  "violations": sum(run.total_violations.values())}
    log(f"kube snapshot {label}: {run.total_objects} objects, "
        f"{out[label]['violations']} violations, {wall:.3f}s ({card})")
    return run


def kube_watched(client, driver, objects, url, ask, out: dict,
                 path_verdicts, card: str, device: str = "cuda") -> tuple:
    """(b), up to the spill: a ``WatchIngester`` over a ``KubeCluster``
    (residency ``auto``): step 1 and a resident pass, both equal to the
    dict relist's run; a 1% churn written over HTTP and its tick, equal to
    a fresh relist of the churned state; then the snapshot spilled with
    the ingester's resume marks.  Returns (spill, the churn tick's run)."""
    from gatekeeper_tpu_torch.__main__ import kube_lister
    from gatekeeper_tpu_torch.audit.manager import (AuditConfig,
                                                    AuditManager)
    from gatekeeper_tpu_torch.parallel.sweep import SweepEvaluator
    from gatekeeper_tpu_torch.snapshot import SnapshotSpill, templates_digest

    kc, ing, snap, mgr, residency = _kube_world(client, driver, url, device)
    try:
        t0 = time.perf_counter()
        rv0 = ask("rv")
        ing.start()
        _wait("the watch replay", lambda: _caught_up(kc, ing.gvks, rv0))
        out["watch_replay_s"] = time.perf_counter() - t0
        step1 = _kube_step(out, "step 1", mgr.audit, card, device)
        _canon_or_raise("step 1 against the path phase", step1,
                        *path_verdicts["reduced"])
        seen_pass = ing.events_seen  # the resident pass pumps up to here
        resident = _kube_step(out, "resident pass", mgr.audit, card, device)
        _canon_or_raise("the resident pass against the path phase",
                        resident, *path_verdicts["reduced"])
        lowered = [s for s in snap.routed_stores() if s.lowered]
        if not lowered or not all(residency.is_resident(s)
                                  for s in lowered) or \
                mgr.perf.get("snapshot_host_chunks", 0.0):
            raise AssertionError("kube snapshot: a group served host "
                                 "columns")
        ops = snapshot_churn(objects, max(8, int(len(objects)
                                                  * CHURN_SHARE)))
        writer = _kube_cluster(url)
        t0 = time.perf_counter()
        try:
            _churn_over_http(writer, ops)
        finally:
            writer.close()
        out["churn_http_s"] = time.perf_counter() - t0
        rv1 = ask("rv")
        _wait("the churn's events", lambda: _caught_up(kc, ing.gvks, rv1))
        tick = _kube_step(out, f"churn tick ({len(ops)} operations)",
                          mgr.audit_tick, card, device)
        # the churn's events and the CLI's boot writes since the resident
        # pass bound the rows the tick may evaluate
        events = ing.events_seen - seen_pass
        rows = mgr.perf.get("last_rows_evaluated", 0)
        if not 0 < rows <= events:
            raise AssertionError(f"kube snapshot: the churn tick evaluated "
                                 f"{rows} rows for {events} watch events")
        relist_kc = _kube_cluster(url)
        try:
            ev = SweepEvaluator(driver, device=device, violations_limit=20,
                                collect="reduced")
            relist = _kube_step(out, "relist of the churned state",
                                AuditManager(
                                    client, lister=kube_lister(relist_kc),
                                    config=AuditConfig(
                                        violations_limit=20,
                                        chunk_size=32768,
                                        exact_totals=False,
                                        submit_window=4),
                                    evaluator=ev).audit, card, device)
        finally:
            relist_kc.close()
        _canon_or_raise("the churn tick against a relist of the churned "
                        "state", tick, relist.kept, relist.total_violations)
        out["mark_wait_s"] = _wait("a resume mark for every watch",
                                   lambda: all(ing.resume_rvs().get(g)
                                               for g in ing.gvks))
        spill = SnapshotSpill(os.path.join(KUBE_DIR, "spill"))
        res = spill.save(snap, rvs=ing.resume_rvs(),
                         templates=templates_digest(client))
        if not res.get("ok"):
            raise AssertionError(f"kube snapshot: spill failed: {res}")
        out["spill"] = {"bytes": res["bytes"], "write_s": res["seconds"],
                        "capture_s": spill.last_capture_s}
        return spill, tick
    finally:
        t0 = time.perf_counter()
        ing.stop()
        kc.close()
        out["close_s"] = time.perf_counter() - t0


def kube_resumed(client, driver, url, ask, spill, tick, out: dict,
                 life_record, card: str, device: str = "cuda") -> tuple:
    """(c): a fresh ``KubeCluster`` and ingester resuming from the spill's
    versions: no LIST request of a data kind (counted on the mock; the
    CLI of (d) audits meanwhile and may list status kinds), the first
    tick equal to (b)'s churn tick.  Returns the resumed world, its
    ingester started."""
    from gatekeeper_tpu_torch.apis.constraints import AUDIT_EP
    from gatekeeper_tpu_torch.snapshot import templates_digest

    world = _kube_world(client, driver, url, device)
    kc, ing, snap, mgr, _residency = world
    stats0 = ask("stats")
    t0 = time.perf_counter()
    loaded = spill.load(snap, [c for c in client.constraints()
                               if c.actions_for(AUDIT_EP)],
                        templates=templates_digest(client))
    load_s = time.perf_counter() - t0
    if loaded is None:
        kc.close()
        raise AssertionError(f"kube snapshot: the spill missed: "
                             f"{spill.stats()['miss_reasons']}")
    ing.from_rvs = dict(loaded["rvs"])
    ing.rvs.update(loaded["rvs"])
    mgr.restore_spill_aux(loaded["aux"])
    ing.start()
    warm = _kube_step(out, "warm first tick", mgr.audit_tick, card, device)
    first_s = time.perf_counter() - t0
    stats1 = ask("stats")
    lists = _lists(stats0, stats1)  # the CLI of (d) may list its own
    data_lists = _lists(stats0, stats1, KUBE_DATA_KINDS)
    replay = (life_record.get("snapshot") or {}).get("replay_s")
    out["warm"] = {"load_s": load_s, "load_and_tick_s": first_s,
                   "list_requests": lists,
                   "discovery_requests": sum(
                       n - stats0.get(k, 0) for k, n in stats1.items()
                       if k[0] == "discovery"),
                   "step1_s": out["step 1"]["wall_s"],
                   "fakecluster_replay_s": replay}
    log(f"kube warm resume: load {load_s:.3f}s, load + first tick "
        f"{first_s:.3f}s against step 1 {out['step 1']['wall_s']:.3f}s "
        f"and the lifecycle phase's FakeCluster replay "
        f"{replay if replay is None else round(replay, 3)}s (at "
        f"{LIFE_SNAPSHOT_OBJECTS} objects); {lists} LIST requests "
        f"({data_lists} of data kinds), "
        f"{out['warm']['discovery_requests']} discovery requests; "
        f"spill {out['spill']['bytes']} bytes ({card})")
    try:
        if data_lists:
            raise AssertionError(f"kube warm resume listed data kinds: "
                                 f"{data_lists}")
        _canon_or_raise("the warm first tick against the churn tick",
                        warm, tick.kept, tick.total_violations)
    except BaseException:
        ing.stop()
        kc.close()
        raise
    return world


def kube_gone(world, objects, ask, out: dict, card: str,
              device: str = "cuda") -> None:
    """(b)'s end, on the resumed world: Pods dropped behind the watches,
    the watch cache compacted and every watch broken with a 410 (the
    relists' DELETED diff absorbed: the snapshot loses exactly those
    rows), then a resync that finds no difference."""
    kc, ing, snap, mgr, _residency = world
    gone = [("Pod", o["metadata"].get("namespace", ""),
             o["metadata"]["name"]) for o in objects
            if o["kind"] == "Pod"][::97][:KUBE_VANISH]
    ing.pump()  # what the watches delivered since (c): the CLI's boot
    rows0 = snap.live_count()
    # (b)'s churn may have deleted some of them already
    dropped = ask("vanish", gone)
    if not dropped:
        raise AssertionError("kube snapshot: no object dropped behind the "
                             "watches")
    t0 = time.perf_counter()
    rv = ask("compact")
    _wait("the 410 relists", lambda: _caught_up(kc, ing.gvks, rv))
    out["relist_410_s"] = time.perf_counter() - t0
    _kube_step(out, "tick after the 410", mgr.audit_tick, card, device)
    if snap.live_count() != rows0 - dropped:
        raise AssertionError(f"kube snapshot: {snap.live_count()} rows "
                             f"after the 410, want {rows0 - dropped}")
    _kube_step(out, "resync", mgr.audit_resync, card, device)
    if mgr.last_resync_diff is not None:
        raise AssertionError(f"kube snapshot: the resync differs: "
                             f"{mgr.last_resync_diff}")
    log(f"kube snapshot: {dropped} objects dropped behind the watches, "
        f"the 410 relists took {out['relist_410_s']:.3f}s, the snapshot "
        f"holds {snap.live_count()} rows, resync diff None ({card})")


def _kubeconfig(path: str, url: str) -> str:
    with open(path, "w") as f:
        f.write(f"apiVersion: v1\nkind: Config\ncurrent-context: mock\n"
                f"contexts:\n- name: mock\n  context: {{cluster: mock, "
                f"user: mock}}\nclusters:\n- name: mock\n  cluster: "
                f"{{server: \"{url}\"}}\nusers:\n- name: mock\n  user: {{}}\n")
    return path


def _export_lines(root: str) -> list:
    out = []
    for dirpath, _d, files in os.walk(root):
        for name in files:
            with open(os.path.join(dirpath, name)) as f:
                out += [json.loads(ln) for ln in f if ln.strip()]
    return out


def _kube_references(conn, ingresses, namespaces, bodies) -> None:
    """A child process of the kube phase: ``_cpu_answers`` over the
    apiserver's Ingresses (the synced inventory) and Namespaces."""
    conn.send(_cpu_answers(ingresses, namespaces, bodies))


class KubeCli:
    """(d)'s CLI process: ``python -m gatekeeper_tpu_torch --kubeconfig K
    --audit-source snapshot --port 0 --emit-audit-events
    --emit-admission-events --export-dir D``, the JAX defaults otherwise;
    its stderr is read on a thread."""

    def __init__(self, url: str, device: str = "cuda"):
        os.makedirs(KUBE_DIR, exist_ok=True)
        self.export = os.path.join(KUBE_DIR, "export")
        cmd = [sys.executable, "-m", "gatekeeper_tpu_torch", "--kubeconfig",
               _kubeconfig(os.path.join(KUBE_DIR, "kubeconfig"), url),
               "--audit-source", "snapshot", "--port", "0",
               "--emit-audit-events", "--emit-admission-events",
               "--export-dir", self.export]
        if device != "cuda":
            cmd += ["--device", device]
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(cmd, cwd=ROOT_DIR,
                                     stderr=subprocess.PIPE, text=True)
        self.lines: list = []
        self.port: list = []
        self.reader = threading.Thread(target=self._read, daemon=True)
        self.reader.start()

    def _read(self):
        for line in self.proc.stderr:
            self.lines.append(line)
            m = re.search(r"webhook serving on :(\d+)", line)
            if m:
                self.port.append(int(m.group(1)))

    def stop(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        self.reader.join(10)


class KubeCliRun:
    """(d)'s apiserver and CLI, started right after the hooks phase's (a)
    so that the CLI's boot and its first audit pass (at the JAX defaults'
    exact totals) run beside the rest of the hooks phase and the kube
    phase's (a)-(c), and beside no ABBA pair of an earlier phase (a pass
    ending or a resync starting in the middle of a pair loads one side
    only): a second mock apiserver child built from the same seed (the
    first, the kube phase's own, sees no write of the CLI), the CLI over
    it once that child has seeded, and ``/healthz`` polled from the
    serving line until it answers 200 (every answer kept), all on a
    thread.  ``wait`` returns once the CLI was started; ``stop`` ends it
    all."""

    def __init__(self, n_objects: int, device: str = "cuda"):
        import multiprocessing
        import shutil

        shutil.rmtree(KUBE_DIR, ignore_errors=True)
        os.makedirs(KUBE_DIR)
        ctx = multiprocessing.get_context("spawn")
        self.conn, child_conn = ctx.Pipe()
        self.child = ctx.Process(target=_kube_apiserver,
                                 args=(child_conn, n_objects),
                                 name="kube-cli-apiserver")
        self.device = device
        self.cli = None
        self.url = None
        self.error = None
        self.stopped = threading.Event()
        self.started = threading.Event()
        self.health: list = []  # (seconds from start, status, doc)
        self.child.start()
        self.thread = threading.Thread(target=self._run, daemon=True,
                                       name="kube-cli")
        self.thread.start()

    def _run(self):
        try:
            if not self.conn.poll(KUBE_WAIT_S):
                raise AssertionError("kube: the CLI's apiserver did not "
                                     "start")
            _ready, self.url, n_server = self.conn.recv()
            if not self.stopped.is_set():
                self.cli = KubeCli(self.url, self.device)
            log(f"kube: the CLI of (d) starts over a second mock apiserver "
                f"{self.url} holding {n_server} objects")
        except BaseException as e:  # noqa: BLE001 — read by wait()
            self.error = e
        finally:
            self.started.set()
        cli = self.cli
        if cli is None:
            return
        while not cli.port:
            if cli.proc.poll() is not None or self.stopped.is_set():
                return
            time.sleep(0.05)
        while cli.proc.poll() is None and not self.stopped.is_set():
            try:
                status, body = _get(cli.port[0], "/healthz")
            except OSError:
                return
            self.health.append((time.perf_counter() - cli.t0, status,
                                json.loads(body)))
            if status == 200:
                return
            time.sleep(0.2)

    def wait(self) -> "KubeCliRun":
        if not self.started.wait(KUBE_WAIT_S) or self.error is not None \
                or self.cli is None:
            raise AssertionError(f"kube: the CLI did not start: "
                                 f"{self.error}")
        return self

    def stop(self):
        import shutil

        self.stopped.set()
        self.started.wait(KUBE_WAIT_S)
        if self.cli is not None:
            self.cli.stop()
        self.thread.join(30)
        if self.child.is_alive():
            self.child.terminate()
            self.child.join(30)
        self.conn.close()
        shutil.rmtree(KUBE_DIR, ignore_errors=True)


def kube_cli_ready(run: "KubeCliRun") -> dict:
    """(d)'s readiness, read from the poller's record: ``/healthz`` 503
    (with its readiness stats, ``ready`` false) until the tracker is
    satisfied, then 200 with every kind satisfied and the 46 templates
    expected, latched."""
    cli = run.wait().cli
    _wait("the CLI's serving line", lambda: cli.port or
          cli.proc.poll() is not None)
    if not cli.port:
        raise AssertionError(f"kube cli exited: {''.join(cli.lines)}")
    _wait("readiness", lambda: run.health and run.health[-1][1] == 200
          or cli.proc.poll() is not None, every=0.2)
    for _t, status, doc in run.health:
        if "readiness" not in doc or status not in (200, 503) or \
                doc["ready"] != (status == 200):
            raise AssertionError(f"kube cli: /healthz {status} {doc}")
    ready_s, _status, doc = run.health[-1]
    stats = doc["readiness"]
    if not all(s["satisfied"] for s in stats.values()) or \
            stats["templates"]["expected"] != 46:
        raise AssertionError(f"kube cli: readiness stats {stats}")
    if _get(cli.port[0], "/healthz")[0] != 200:
        raise AssertionError("kube cli: readiness did not latch")
    return {"serving_s": None, "ready_s": ready_s,
            "healthz_codes": dict(collections.Counter(
                status for _t, status, _d in run.health))}


def kube_cli(cli: "KubeCli", url, bodies, refs, out: dict,
             card: str) -> dict:
    """(d) once the CLI is ready (``kube_cli_ready``): the bodies from 64
    clients, every answer equal to the CPU handler's (``refs``) or of the
    JAX shed form, and the shed ones posted again by 8 clients until each
    has a reviewed answer equal to the CPU handler's; a constraint written
    after boot turns a later answer into a deny (and is deleted again); the
    template's status object."""
    kc = _kube_cluster(url)
    port = cli.port[0]
    try:
        retry: dict = {}
        replies, lat, wall = post_concurrently(port, bodies,
                                               retry_after=retry)
        out.update(_rate(len(bodies), lat, wall))
        shed = [i for i in range(len(bodies))
                if _answer(replies[i])[1] == 429]
        bad = [i for i in shed if not _shed_form(_answer(replies[i]),
                                                 retry.get(i))]
        if bad:
            raise AssertionError(f"kube cli: {len(bad)} code-429 answers "
                                 f"not of the shed form: "
                                 f"{_answer(replies[bad[0]])}")
        out["shed"] = len(shed)
        rounds = 0
        while shed:
            rounds += 1
            if rounds > 5:
                raise AssertionError(f"kube cli: {len(shed)} bodies still "
                                     f"shed after 5 rounds at 8 clients")
            again, _lat, _w = post_concurrently(
                port, [bodies[i] for i in shed], procs=1, conns=8)
            for j, i in enumerate(shed):
                replies[i] = again[j]
            shed = [i for i in shed if _answer(replies[i])[1] == 429]
        out["retry_rounds"] = rounds
        diffs = [i for i in range(len(bodies))
                 if _unordered(_answer(replies[i])) != _unordered(refs[i])]
        code500 = sum(_answer(r)[1] == 500 for r in replies.values())
        out["denied"] = sum(not _answer(r)[0] for r in replies.values())
        log(f"kube cli: {len(bodies)} admissions in {wall:.3f}s, "
            f"{out['per_s']:.1f}/s, p50 {out['p50_ms']:.3f} ms, p99 "
            f"{out['p99_ms']:.3f} ms, {out['shed']} shed (the JAX shed "
            f"form, posted again by 8 clients in {rounds} rounds); "
            f"{out['denied']} denied, {len(diffs)} differ from the CPU "
            f"handler, {code500} with code 500 ({card})")
        if diffs or code500:
            i = (diffs or [0])[0]
            raise AssertionError(f"kube cli: answers differ from the CPU "
                                 f"handler, first {i}: "
                                 f"{_answer(replies[i])} against {refs[i]}")
        kc.apply(copy.deepcopy(KUBE_LATE_CONSTRAINT))
        t0 = time.perf_counter()
        probe = admission_body(
            {"apiVersion": "v1", "kind": "Namespace",
             "metadata": {"name": "kube-late",
                          "labels": {"owner": "me.agilebank.demo"}}},
            "kube-late")

        def late_deny():
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
            try:
                conn.request("POST", "/v1/admit", json.dumps(probe),
                             {"Content-Type": "application/json"})
                resp = json.loads(conn.getresponse().read())["response"]
            finally:
                conn.close()
            return "[all-must-have-team]" in (resp.get("status") or {}).get(
                "message", "")
        _wait("the late constraint's deny", late_deny, every=0.5)
        out["late_constraint_s"] = time.perf_counter() - t0
        # deleted again: the audit loop's next tick then sees the constraint
        # set it last evaluated, and re-evaluates nothing at the drain
        kc.delete(copy.deepcopy(KUBE_LATE_CONSTRAINT))
        _wait("the late constraint's removal", lambda: not late_deny(),
              every=0.5)
        status_obj = kc.get((STATUS_GROUP, "v1beta1",
                             "ConstraintTemplatePodStatus"),
                            "gatekeeper-system",
                            "gatekeeper-tpu-0-constrainttemplate-"
                            "k8srequiredlabels")
        if status_obj is None or not status_obj["status"].get("created"):
            raise AssertionError(f"kube cli: template status {status_obj}")
    finally:
        kc.close()
    return out


def kube_cli_end(run: "KubeCliRun", bodies, refs, card: str) -> dict:
    """(d): readiness (``kube_cli_ready``), the first audit pass's export,
    the burst and the late constraint (``kube_cli``), the audit's
    violations in the export and audit and admission Events on the
    apiserver; then SIGTERM, a drain and exit 0."""
    import signal

    cli = run.cli
    out = kube_cli_ready(run)
    _wait("the first audit pass's export", lambda: any(
        ln.get("event") == "audit_ended"
        for ln in _export_lines(cli.export)), every=0.5)
    out["first_audit_s"] = time.perf_counter() - cli.t0
    kube_cli(cli, run.url, bodies, refs, out, card)
    kc = _kube_cluster(run.url)
    try:
        components = collections.Counter()

        def events():
            components.clear()
            components.update(e.get("source", {}).get("component")
                              for e in kc.list(("", "v1", "Event")))
            return components["gatekeeper-audit"] and \
                components["gatekeeper-webhook"]
        _wait("audit and admission Events", events, every=0.5)
        exported = collections.Counter(ln.get("event")
                                       for ln in _export_lines(cli.export))
        if not exported["violation"]:
            raise AssertionError(f"kube cli: export {dict(exported)}")
        t0 = time.perf_counter()
        cli.proc.send_signal(signal.SIGTERM)
        rc = cli.proc.wait(timeout=KUBE_WAIT_S)
        out.update({"events": dict(components), "exported": dict(exported),
                    "drain_s": time.perf_counter() - t0, "rc": rc})
    finally:
        kc.close()
        cli.stop()
    log(f"kube cli: ready {out['ready_s']:.3f}s after start (/healthz "
        f"{out['healthz_codes']}), first audit pass exported by "
        f"{out['first_audit_s']:.3f}s; the late constraint denied after "
        f"{out['late_constraint_s']:.3f}s; Events {out['events']}; "
        f"exported {out['exported']}; SIGTERM to exit {rc} in "
        f"{out['drain_s']:.3f}s ({card})")
    if rc != 0 or not any("drain complete" in ln for ln in cli.lines):
        raise AssertionError(f"kube cli: exit {rc}: "
                             f"{''.join(cli.lines[-40:])}")
    return out


def kube_phase(objects, path_verdicts, path_timings, life_record,
               cli_run: "KubeCliRun", card: str, device: str = "cuda",
               n_bodies: int = KUBE_BODIES) -> tuple:
    """The served process over an apiserver, (a)-(d): (launches, shapes,
    record).  (a)-(c) and the 410 step run against the port's mock in a
    spawned child process holding the library and ``objects`` (rebuilt
    there from the same seed); fold launches count over them, in this
    process.  (d) reads ``cli_run``, the CLI started after the hooks
    phase's (a) over a second such child; its CPU reference answers come
    from a third child process, beside the 410 step and the resync."""
    import multiprocessing

    from gatekeeper_tpu_torch.ops import fold

    for wrapper in (fold.fused_fold, fold.epilogue):
        wrapper.launches = 0
        wrapper.shapes.clear()
    ctx = multiprocessing.get_context("spawn")
    conn, child_conn = ctx.Pipe()
    child = ctx.Process(target=_kube_apiserver, args=(child_conn,
                                                      len(objects)),
                        name="kube-apiserver")
    lock = threading.Lock()

    def ask(cmd, arg=None):
        with lock:
            conn.send((cmd, arg))
            if not conn.poll(KUBE_WAIT_S):
                raise AssertionError(f"kube: the apiserver did not answer "
                                     f"{cmd}")
            return conn.recv()

    record: dict = {"timeline": {}}
    t_phase = time.perf_counter()

    def mark(name):
        record["timeline"][name] = time.perf_counter() - t_phase

    refs_proc = refs_conn = world = None
    child.start()
    try:
        if not conn.poll(KUBE_WAIT_S):
            raise AssertionError("kube: the apiserver did not start")
        _ready, url, n_server = conn.recv()
        mark("apiserver seeded")
        log(f"kube: mock apiserver {url} (pid {child.pid}) holds {n_server} "
            f"objects, seeded in "
            f"{record['timeline']['apiserver seeded']:.3f}s")
        client, driver, _nt, _nc = _client(objects, device=device)
        mark("client")
        record["relist"] = kube_relist(client, driver, url, ask,
                                       path_verdicts, path_timings, card,
                                       device)
        mark("(a) relists")
        gc.collect()
        snap_rec: dict = {}
        record["snapshot"] = snap_rec
        spill, tick = kube_watched(client, driver, objects, url, ask,
                                   snap_rec, path_verdicts, card, device)
        mark("(b) watched")
        gc.collect()
        world = kube_resumed(client, driver, url, ask, spill, tick,
                             snap_rec, life_record, card, device)
        mark("(c) resumed")
        # (d)'s references, over the CLI's apiserver's Namespaces and
        # Ingresses (the synced inventory), in a child process beside the
        # 410 step and the resync
        bodies, _objs = admission_traffic(n_bodies)
        reader = _kube_cluster(cli_run.wait().url)
        try:
            namespaces = {o["metadata"]["name"]: o
                          for o in reader.list(("", "v1", "Namespace"))}
            ingresses = reader.list(("networking.k8s.io", "v1", "Ingress"))
        finally:
            reader.close()
        refs_conn, child_refs = ctx.Pipe()
        refs_proc = ctx.Process(target=_kube_references,
                                args=(child_refs, ingresses, namespaces,
                                      bodies), name="kube-references")
        refs_proc.start()
        kube_gone(world, objects, ask, snap_rec, card, device)
        mark("(b) 410 and resync")
        world[1].stop()
        world[0].close()
        world = None
        launches = {"fused_fold": fold.fused_fold.launches,
                    "epilogue": fold.epilogue.launches}
        shapes = {"fused_fold": dict(fold.fused_fold.shapes),
                  "epilogue": dict(fold.epilogue.shapes)}
        record["requests"] = {f"{v}/{k}": n for (v, k), n in
                              sorted(ask("stats").items())}
        ask("stop")
        child.join(30)
        gc.collect()
        if not refs_conn.poll(KUBE_WAIT_S):
            raise AssertionError("kube: the CPU references did not arrive")
        refs = refs_conn.recv()
        refs_proc.join(30)
        mark("(d) references")
        record["cli"] = kube_cli_end(cli_run, bodies, refs, card)
        mark("(d) cli")
    finally:
        if world is not None:
            world[1].stop()
            world[0].close()
        if refs_proc is not None and refs_proc.is_alive():
            refs_proc.terminate()
            refs_proc.join(30)
        if refs_conn is not None:
            refs_conn.close()
        if child.is_alive():
            child.terminate()
            child.join(30)
        conn.close()
    timeline = {k: round(v, 3) for k, v in record["timeline"].items()}
    log(f"kube: timeline (s from the phase's start) {timeline}; fold "
        f"launches {launches} at (C, N, k) "
        f"{ {k: sorted(v) for k, v in shapes.items()} }")
    if device == "cuda" and min(launches.values()) <= 0:
        raise AssertionError(f"kube: a fold kernel never launched: "
                             f"{launches}")
    return launches, shapes, record


# --- gator: the offline enforcement point's commands -------------------------
GATOR_DIR = os.path.join(ROOT_DIR, "_gator")
# the sweep engine's objects and the spill's rows: halved from 8,192 after
# the phase took 222.1 s at that width on the card (the budget is ~120 s)
GATOR_OBJECTS = 4096
GATOR_REVIEW_OBJECTS = 4096  # the tpu and mutate engines' objects
GATOR_BODIES = 512  # admissions captured for replay (cut from 1,024)
GATOR_CLIENTS = 64  # threads posting them to the handler


def _gator(argv, launches=None, shapes=None) -> tuple:
    """``python -m gatekeeper_tpu_torch.gator ARGV`` in this process:
    (exit code, stdout), stderr logged.  With ``launches``/``shapes`` the
    fold kernels' launches inside the call add up there
    (``_fold_counted``)."""
    import contextlib
    import io

    from gatekeeper_tpu_torch.gator.cli import main

    fn = main if launches is None else _fold_counted(main, launches, shapes)
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = fn(list(argv))
    for line in err.getvalue().splitlines()[:8]:
        log(f"gator {argv[2] if argv[0] == '--device' else argv[0]}: {line}")
    return rc, out.getvalue()


def _gator_json(label: str, argv, **counted):
    """The JSON that an in-process ``_gator`` run printed, once it exited
    0."""
    rc, out = _gator(argv, **counted)
    if rc != 0:
        raise AssertionError(f"gator {label}: exit {rc}: {out[-2000:]}")
    return json.loads(out)


def _write_json(name: str, docs) -> str:
    path = os.path.join(GATOR_DIR, name)
    with open(path, "w") as f:
        json.dump(docs, f)
    return path


def _gator_step(record: dict, name: str, t0: float) -> float:
    record["walls"][name] = time.perf_counter() - t0
    log(f"gator: {name} in {record['walls'][name]:.3f}s")
    return time.perf_counter()


def _policy_client(policy, device: str, compile_cache=None) -> tuple:
    """(client, driver) of ``__main__.new_client`` on ``device`` with the
    templates of ``policy``, then its constraints, installed."""
    from gatekeeper_tpu_torch.__main__ import new_client

    client, driver = new_client(device=device, compile_cache=compile_cache)
    for doc in sorted(policy, key=lambda d: d["kind"] != "ConstraintTemplate"):
        if doc["kind"] == "ConstraintTemplate":
            client.add_template(copy.deepcopy(doc))
        else:
            client.add_constraint(copy.deepcopy(doc))
    return client, driver


def gator_capture(policy, bodies, sink: str, cache_dir: str,
                  device: str) -> dict:
    """The corpus ``gator replay`` reads: ``bodies`` answered by the port's
    ``ValidationHandler`` over the library on ``device`` (a ``Batcher``
    whose batches all take the grid lane, as replay's ``review_batch``
    does; the compile cache replay reads warm), from ``GATOR_CLIENTS``
    threads, with a capture-mode flight recorder writing ``sink``."""
    from concurrent.futures import ThreadPoolExecutor

    from gatekeeper_tpu_torch.drivers.generation import CompileCache
    from gatekeeper_tpu_torch.observability import flightrec
    from gatekeeper_tpu_torch.webhook.policy import (Batcher,
                                                     ValidationHandler)

    client, _driver = _policy_client(policy, device,
                                     compile_cache=CompileCache(cache_dir))
    batcher = Batcher(client, small_batch=0).start()
    rec = flightrec.FlightRecorder(capacity=64, sink_path=sink, capture=True)
    handler = ValidationHandler(client, batcher=batcher)
    t0 = time.perf_counter()
    try:
        with flightrec.activate(rec), \
                ThreadPoolExecutor(GATOR_CLIENTS) as pool:
            answers = list(pool.map(handler.handle, bodies))
        _sync(device)
    finally:
        batcher.stop()
        rec.close()
    wall = time.perf_counter() - t0
    denies = sum(not a.allowed for a in answers)
    codes = collections.Counter(a.code for a in answers if not a.allowed)
    if codes.get(500) or not denies:
        raise AssertionError(f"gator capture: {denies} denies, codes "
                             f"{dict(codes)}")
    return {"bodies": len(bodies), "denies": denies,
            "rate_per_s": len(bodies) / wall, "wall_s": wall}


def gator_spill(policy, objects, root: str, device: str) -> int:
    """A ``--snapshot-spill`` of ``objects`` as the CLI's snapshot audit
    writes it (reduced lane on ``device``); returns its rows."""
    from gatekeeper_tpu_torch.audit.manager import AuditConfig, AuditManager
    from gatekeeper_tpu_torch.parallel.sweep import SweepEvaluator
    from gatekeeper_tpu_torch.snapshot import (ClusterSnapshot,
                                               SnapshotConfig, SnapshotSpill,
                                               templates_digest)
    from gatekeeper_tpu_torch.sync.source import FakeCluster

    client, driver = _policy_client(policy, device)
    cluster = FakeCluster()
    for o in objects:
        cluster.apply(copy.deepcopy(o))
    ev = SweepEvaluator(driver, device=device, violations_limit=20)
    snap = ClusterSnapshot(ev, SnapshotConfig())
    mgr = AuditManager(client, lister=lambda: iter(cluster.list()),
                       config=AuditConfig(audit_source="snapshot",
                                          chunk_size=32768,
                                          exact_totals=False),
                       evaluator=ev, snapshot=snap)
    run = mgr.audit()
    if run.incomplete:
        raise AssertionError("gator spill: the snapshot audit was "
                             "incomplete")
    wrote = SnapshotSpill(root).save(snap, templates=templates_digest(client))
    if not wrote or not wrote.get("ok"):
        raise AssertionError(f"gator spill: not written: {wrote}")
    return wrote["rows"]


def gator_reference(policy, objects, device: str) -> int:
    """The sweep engine's violations by another road: an ``AuditManager``
    at the audit's defaults (chunks of 500, exact totals) over the same
    templates, constraints and objects."""
    from gatekeeper_tpu_torch.audit.manager import AuditManager
    from gatekeeper_tpu_torch.parallel.sweep import SweepEvaluator

    client, driver = _policy_client(policy, device)
    for o in objects:
        client.add_data(copy.deepcopy(o))
    mgr = AuditManager(client, lister=lambda: iter(objects),
                       evaluator=SweepEvaluator(driver, device=device))
    run = mgr.audit()
    if run.incomplete:
        raise AssertionError("gator: the reference audit was incomplete")
    return sum(run.total_violations.values())


# the reference AuditManager of the gator phase in a child process:
# argv[1:] = policy file, objects file, device; prints the violations
_GATOR_REFERENCE = r"""
import json, sys
import chip_smoke
policy, objects = (json.load(open(p)) for p in sys.argv[1:3])
print(chip_smoke.gator_reference(policy, objects, sys.argv[3]))
"""


def _gator_proc(argv, name: str, module: bool = True):
    """``python -m gatekeeper_tpu_torch.gator ARGV`` (or, with ``module``
    False, ``python ARGV``) as a child process (cwd the checkout), its
    stdout to ``GATOR_DIR/NAME``: (Popen, path)."""
    path = os.path.join(GATOR_DIR, name)
    head = ["-m", "gatekeeper_tpu_torch.gator"] if module else []
    with open(path, "w") as out:
        proc = subprocess.Popen(
            [sys.executable, *head, *argv], cwd=ROOT_DIR, stdout=out,
            stderr=subprocess.PIPE, text=True)
    return proc, path


def _gator_proc_out(label: str, started) -> str:
    """The stdout of a ``_gator_proc`` child once it exited 0."""
    proc, path = started
    try:
        _out, err = proc.communicate(timeout=900)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise AssertionError(f"gator {label}: the child process hung")
    with open(path) as f:
        out = f.read()
    if proc.returncode != 0:
        raise AssertionError(f"gator {label}: exit {proc.returncode}: "
                             f"{err[-2000:]}")
    return out


def gator_phase(objects, card: str, device: str = "cuda") -> tuple:
    """``gatekeeper_tpu_torch.gator`` through its CLI entry point: (launches,
    shapes, record).  The masks lane's sweep engine and the replay runs run
    in this process (fold launches counted over them); ``verify``, the
    ``--device cpu`` references, the reduced lane, the grid and mutation
    engines, the reference audit and the spill's replay run as child
    processes beside them (the host's render bounds each)."""
    import shutil

    launches = {"fused_fold": 0, "epilogue": 0}
    shapes = {"fused_fold": collections.Counter(),
              "epilogue": collections.Counter()}
    counted = {"launches": launches, "shapes": shapes}
    dev = ["--device", device]
    record: dict = {"walls": {}, "launches_after": {}}
    shutil.rmtree(GATOR_DIR, ignore_errors=True)
    os.makedirs(GATOR_DIR)
    children: dict = {}

    def step(name: str, t: float) -> float:
        record["launches_after"][name] = dict(launches)
        return _gator_step(record, name, t)

    t_phase = t0 = time.perf_counter()
    try:
        policy = library_policy_docs()
        sweep_objs = objects[:GATOR_OBJECTS]
        rev_objs = objects[:GATOR_REVIEW_OBJECTS]
        f_policy = _write_json("policy.json", policy)
        f_objs = _write_json("objects.json", sweep_objs)
        f_prefix = _write_json("prefix.json", sweep_objs[:CPU_PREFIX])
        f_rev = _write_json("review.json", rev_objs)
        f_mut = _write_json("mutate.json", mutators() + rev_objs)
        sweep = ["bench", "-f", f_policy, "-f", f_objs, "--engine",
                 "sweep", "-n", "1", "-o", "json"]
        review = {"tpu": ["bench", "-f", f_policy, "-f", f_rev, "--engine",
                          "tpu", "-o", "json"],
                  "mutate": ["bench", "-f", f_mut, "--engine", "mutate",
                             "-o", "json"]}
        # the entry point out of process (a host without JAX), the --device
        # cpu references (one pass each) and the grid and mutation engines
        # on the card (they launch no fold kernel), beside the runs below
        children["verify"] = _gator_proc(["verify", "library"],
                                         "verify.txt")
        children["cpu sweep"] = _gator_proc(
            ["--device", "cpu", "bench", "-f", f_policy, "-f", f_prefix,
             "--engine", "sweep", "-n", "1", "-o", "json", "--collect",
             "masks"], "cpu-sweep.json")
        for e in ("tpu", "mutate"):
            children[f"cpu {e}"] = _gator_proc(
                ["--device", "cpu", *review[e], "-n", "1"], f"cpu-{e}.json")
        for e in ("tpu", "mutate"):
            children[e] = _gator_proc(dev + review[e] + ["-n", "3"],
                                      f"card-{e}.json")
        children["reduced"] = _gator_proc(
            dev + sweep + ["--collect", "reduced"], "card-reduced.json")
        children["reference"] = _gator_proc(
            ["-c", _GATOR_REFERENCE, f_policy, f_objs, device],
            "reference.txt", module=False)
        # (1) gator test over the library, twice
        runs = [_gator(["test", "-f", os.path.join(ROOT_DIR, "library"),
                        "-o", "json"]) for _ in range(2)]
        if runs[0] != runs[1] or runs[0][0] != 1:
            raise AssertionError(f"gator test: exit codes "
                                 f"{[r[0] for r in runs]}, equal "
                                 f"{runs[0] == runs[1]}")
        record["test_results"] = len(json.loads(runs[0][1]))
        t0 = step(f"test ({record['test_results']} results, exit 1, twice)",
                  t0)
        # (2) the spill, replayed by a child process
        spill = os.path.join(GATOR_DIR, "spill")
        rows = gator_spill(policy, sweep_objs, spill, device)
        children["from spill"] = _gator_proc(
            dev + ["replay", "--from-spill", spill, "--candidate", f_policy,
                   "--differential", "-o", "json"], "from-spill.json")
        t0 = step(f"spill ({rows} rows)", t0)
        # (3) the sweep engine at the audit's defaults, masks lane (the
        # reduced lane runs in a child)
        masks = _gator_json("bench sweep masks",
                            dev + sweep + ["--collect", "masks"],
                            **counted)[0]
        if device == "cuda" and launches["epilogue"] <= 0:
            raise AssertionError(f"gator bench sweep masks: epilogue never "
                                 f"launched: {launches}")
        t0 = step("bench sweep masks", t0)
        card_prefix = None if len(sweep_objs) <= CPU_PREFIX else \
            gator_reference(policy, sweep_objs[:CPU_PREFIX], device)
        # (4) expand, differential lane
        deployments = [o for o in sweep_objs if o["kind"] == "Deployment"]
        f_exp = _write_json("expand.json", [EXPAND_DEPLOYMENTS] + mutators()
                            + deployments)
        rc, out = _gator(dev + ["expand", "-f", f_exp, "--lane",
                                "differential"], **counted)
        if rc != 0 or out.count("kind: Pod") != len(deployments):
            raise AssertionError(f"gator expand: exit {rc}, "
                                 f"{out.count('kind: Pod')} Pods for "
                                 f"{len(deployments)} Deployments")
        t0 = step(f"expand differential ({len(deployments)} Deployments)",
                  t0)
        # (5) replay: capture, the warm differential, a lacking candidate
        bodies, _objs = admission_traffic(GATOR_BODIES)
        sink = os.path.join(GATOR_DIR, "decisions.jsonl")
        cache = os.path.join(GATOR_DIR, "compile-cache")
        record["capture"] = gator_capture(policy, bodies, sink, cache,
                                          device)
        t0 = step("replay capture", t0)
        replay = ["replay", "-f", sink, "--compile-cache", cache, "-o",
                  "json"]
        same = _gator_json("replay --differential", dev + replay + [
            "--candidate", f_policy, "--differential"], **counted)
        if same["records"] != len(bodies) or same["divergences_total"] or \
                not same["differential"]["bit_identical"] or \
                same["compile_cache"].get("misses", 0) != 0:
            raise AssertionError(
                f"gator replay --differential: {same['records']} records, "
                f"{same['divergences_total']} divergences, "
                f"{same['differential']['mismatches_total']} mismatches, "
                f"compile cache {same['compile_cache']}: "
                f"{json.dumps(same['differential']['mismatches'][:3])}")
        t0 = step("replay --differential", t0)
        from gatekeeper_tpu_torch.replay.core import (read_corpus,
                                                      recorded_constraints)

        denied = sorted(set().union(*[
            recorded_constraints(r.get("message", ""))
            for r in read_corpus(sink)[0] if r["decision"] == "deny"]))
        drop = denied[0]
        f_lacking = _write_json("lacking.json", [
            d for d in policy if d["metadata"]["name"] != drop
            or d["kind"] == "ConstraintTemplate"])
        lacking = _gator_json("replay (lacking candidate)", dev + replay + [
            "--candidate", f_lacking, "--max-divergences", "100000"],
            **counted)
        removed_ok = all(d["kind"] == "newly_allowed"
                         and drop in d["constraints_removed"]
                         for d in lacking["divergences"])
        per = lacking["by_constraint"].get(drop, {})
        if lacking["newly_allowed"] <= 0 or lacking["newly_denied"] or \
                per.get("newly_allowed", 0) <= 0 or not removed_ok:
            raise AssertionError(
                f"gator replay without {drop}: newly_allowed "
                f"{lacking['newly_allowed']}, newly_denied "
                f"{lacking['newly_denied']}, by_constraint "
                f"{lacking['by_constraint']}")
        record["replay"] = {
            "decisions_per_s": same["decisions_per_s"],
            "wall_s": same["wall_s"], "recorded": same["recorded"],
            "dropped": drop, "newly_allowed": lacking["newly_allowed"],
            "lacking_decisions_per_s": lacking["decisions_per_s"]}
        log(f"gator replay: {same['records']} decisions bit-identical at "
            f"{same['decisions_per_s']}/s, compile cache "
            f"{same['compile_cache']}; without {drop}: "
            f"{lacking['newly_allowed']} newly allowed, all attributed to "
            f"it ({card})")
        t0 = step("replay (lacking candidate)", t0)
        for argv in (["decisions", "-f", sink, "--limit", "5"],
                     ["triage", "-f", sink]):
            rc, out = _gator(argv)
            if rc != 0 or not out:
                raise AssertionError(f"gator {argv[0]}: exit {rc}")
        t0 = step("decisions and triage", t0)
        # (6) the child processes' results
        out = _gator_proc_out("verify", children["verify"])
        passed = len(re.findall(r"^ok\t", out, re.M))
        if passed != 46:
            raise AssertionError(f"gator verify: {passed} suites ok")
        got = {name: json.loads(_gator_proc_out(name, children[name]))
               for name in ("cpu sweep", "cpu tpu", "cpu mutate", "tpu",
                            "mutate", "reduced", "reference", "from spill")}
        t0 = step("the child processes' ends", t0)
        reduced, ref = got["reduced"][0], got["reference"]
        if card_prefix is None:
            card_prefix = ref
        for lane, r in (("masks", masks), ("reduced", reduced)):
            record[f"sweep_{lane}"] = {
                k: r[k] for k in ("objects", "violations", "reviews_per_sec",
                                  "p50_ms", "p99_ms", "total_eval_s")}
            record[f"sweep_{lane}"]["schedule"] = r["pipeline"]["schedule"]
        cpu_sweep = got["cpu sweep"][0]
        log(f"gator bench sweep: masks {masks['violations']} violations, "
            f"{masks['reviews_per_sec']} reviews/s, p50 {masks['p50_ms']} "
            f"ms, p99 {masks['p99_ms']} ms; reduced "
            f"{reduced['violations']}, {reduced['reviews_per_sec']} "
            f"reviews/s; AuditManager {ref}; cpu prefix "
            f"{cpu_sweep['violations']} == card prefix {card_prefix} "
            f"({card})")
        if not (masks["violations"] == reduced["violations"] == ref > 0) \
                or masks["objects"] != len(sweep_objs) \
                or cpu_sweep["violations"] != card_prefix \
                or masks["lowering"]["fallback"] != 0:
            raise AssertionError(
                f"gator bench sweep: masks {masks['violations']}, reduced "
                f"{reduced['violations']}, reference {ref}, cpu prefix "
                f"{cpu_sweep['violations']} against {card_prefix}, "
                f"lowering {masks['lowering']}")
        for engine in ("tpu", "mutate"):
            r = got[engine][0]
            record[f"bench_{engine}"] = r = {
                k: r[k] for k in ("objects", "violations", "reviews_per_sec",
                                  "p50_ms", "p99_ms")}
            cpu_v = got[f"cpu {engine}"][0]["violations"]
            log(f"gator bench {engine}: {r['objects']} objects, "
                f"{r['violations']} "
                f"{'patch ops' if engine == 'mutate' else 'violations'}, "
                f"{r['reviews_per_sec']}/s, p50 {r['p50_ms']} ms, p99 "
                f"{r['p99_ms']} ms; cpu {cpu_v} ({card})")
            if r["violations"] != cpu_v or r["violations"] <= 0:
                raise AssertionError(f"gator bench {engine}: card "
                                     f"{r['violations']}, cpu {cpu_v}")
        from_spill = got["from spill"]
        if from_spill["rows"] != len(sweep_objs) or \
                not from_spill["differential"]["bit_identical"] or \
                from_spill["errors"]:
            raise AssertionError(
                f"gator replay --from-spill: {from_spill['rows']} rows, "
                f"errors {from_spill['errors']}, mismatches "
                f"{from_spill['differential']['mismatches_total']}: "
                f"{json.dumps(from_spill['differential']['mismatches'][:3])}")
        record["from_spill"] = {k: from_spill[k] for k in
                                ("rows", "decisions_per_s", "wall_s")}
        log(f"gator replay --from-spill: {from_spill['rows']} rows "
            f"bit-identical at {from_spill['decisions_per_s']}/s ({card})")
    finally:
        for proc, _path in children.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        shutil.rmtree(GATOR_DIR, ignore_errors=True)
    record["wall_s"] = time.perf_counter() - t_phase
    record["launches"] = dict(launches)
    log(f"gator: {record['wall_s']:.1f}s; fold launches {launches} at "
        f"(C, N, k) { {k: sorted(v) for k, v in shapes.items()} } ({card})")
    if device == "cuda" and launches["epilogue"] <= 0:
        raise AssertionError(f"gator: epilogue never launched: {launches}")
    return launches, {k: dict(v) for k, v in shapes.items()}, record


CANARY_DIR = os.path.join(ROOT_DIR, "_canary")
CANARY_OBJECTS = 8192  # (a): the roster's objects, the path's first
CANARY_CLUSTERS = 32
CANARY_SIZES = (64, 512)  # (a): objects of one cluster, at least, at most
CANARY_SMALL = 8  # (a): clusters on the library less CANARY_LESS templates
CANARY_LESS = 4
CANARY_PREFIX = 4  # (a): clusters of the --device cpu run and of the CLI's
CANARY_BODIES = 512  # (b): admissions with the shadow lane (cut from 1,024)
CANARY_SEED = 13
# the keys of the JAX package's ShadowLane.snapshot(), /debug/shadow's body
SHADOW_KEYS = ("state", "submitted", "evaluated", "dropped", "skipped",
               "lane_errors", "queue_depth", "decisions", "divergences",
               "divergence_rate", "recent_divergences",
               "candidate_lowering")


def canary_roster(objects) -> list:
    """[(cluster id, "full" | "small", objects)]: the first CANARY_OBJECTS
    objects split by a seeded draw into CANARY_CLUSTERS clusters of
    CANARY_SIZES objects each; CANARY_SMALL clusters, drawn too, run the
    library less CANARY_LESS templates."""
    rng = np.random.default_rng(CANARY_SEED)
    lo, hi = CANARY_SIZES
    n = min(CANARY_OBJECTS, len(objects))
    if not lo * CANARY_CLUSTERS <= n <= hi * CANARY_CLUSTERS:
        raise AssertionError(f"canary: {n} objects do not split into "
                             f"{CANARY_CLUSTERS} clusters of {CANARY_SIZES}")
    sizes = [lo] * CANARY_CLUSTERS
    left = n - lo * CANARY_CLUSTERS
    while left > 0:
        i = int(rng.integers(CANARY_CLUSTERS))
        add = min(left, int(rng.integers(1, 65)), hi - sizes[i])
        sizes[i] += add
        left -= add
    order = rng.permutation(n)
    small = {int(i) for i in rng.choice(CANARY_CLUSTERS, CANARY_SMALL,
                                        replace=False)}
    roster, off = [], 0
    for i, size in enumerate(sizes):
        roster.append((f"c{i:02d}", "small" if i in small else "full",
                       [objects[int(j)] for j in order[off:off + size]]))
        off += size
    return roster


def canary_libraries() -> dict:
    """{"full": the library's templates and sample constraints, "small":
    the same less CANARY_LESS templates (spread over the sorted kinds) and
    their constraints}."""
    full = library_policy_docs()
    kinds = sorted(_template_kind(d) for d in full
                   if d["kind"] == "ConstraintTemplate")
    less = set(kinds[::len(kinds) // CANARY_LESS][:CANARY_LESS])
    small = [d for d in full
             if (_template_kind(d) if d["kind"] == "ConstraintTemplate"
                 else d["kind"]) not in less]
    return {"full": full, "small": small}


def _fleet_args(device: str):
    """The CLI's flags that ``fleet.run._build_runtime_factory`` reads, at
    their defaults."""
    return argparse.Namespace(device=device, constraint_violations_limit=20,
                              flatten_lane="auto", collect="reduced",
                              flatten_workers=0)


def _canary_summary(run) -> dict:
    """A run as JSON: objects, totals and kept lists keyed kind/name."""
    return {"objects": run.total_objects,
            "incomplete": run.incomplete,
            "totals": {f"{k}/{n}": v
                       for (k, n), v in sorted(run.total_violations.items())},
            "kept": {f"{k}/{n}": [[v.kind, f"{v.namespace}/{v.name}",
                                   v.message] for v in vs]
                     for (k, n), vs in sorted(run.kept.items())}}


def _fake_cluster(objects):
    from gatekeeper_tpu_torch.sync.source import FakeCluster

    src = FakeCluster()
    for o in objects:
        src.apply(copy.deepcopy(o))
    return src


def canary_reference(spec_path: str, device: str, mode: str) -> dict:
    """The fleet's references, as a child process runs them over the
    roster file ``spec_path`` ({"libraries": {name: file}, "clusters":
    [[id, library, objects file], ...]}): ``independent`` sweeps every
    cluster alone through an ``AuditManager`` (snapshot source, chunks of
    500, exact totals) on a runtime of its library; ``fleet`` runs a
    ``FleetEvaluator`` over the roster.  Returns {"summaries": {id:
    ``_canary_summary``}, "dispatches": device dispatches, "wall_s"}."""
    from gatekeeper_tpu_torch.audit.manager import AuditConfig, AuditManager
    from gatekeeper_tpu_torch.fleet import FleetEvaluator
    from gatekeeper_tpu_torch.fleet.config import library_key
    from gatekeeper_tpu_torch.fleet.run import _build_runtime_factory
    from gatekeeper_tpu_torch.snapshot import ClusterSnapshot, SnapshotConfig

    with open(spec_path) as f:
        spec = json.load(f)
    libs = {}
    for name, path in spec["libraries"].items():
        with open(path) as f:
            libs[name] = json.load(f)
    t0 = time.perf_counter()
    out: dict = {}
    if mode == "fleet":
        fleet = FleetEvaluator()
        try:
            for cid, lib, path in spec["clusters"]:
                with open(path) as f:
                    fleet.add_cluster(cid, _fake_cluster(json.load(f)),
                                      library_key(libs[lib]),
                                      _build_runtime_factory(
                                          libs[lib], None, None,
                                          _fleet_args(device)))
            runs = fleet.sweep(full=True)
            _sync(device)
        finally:
            fleet.stop()
        out["dispatches"] = fleet.packed_dispatches + \
            fleet.unpacked_dispatches
    else:
        runtimes = {name: _build_runtime_factory(
            docs, None, None, _fleet_args(device))() for name, docs in
            libs.items()}
        runs = {}
        for cid, lib, path in spec["clusters"]:
            client, _driver, ev = runtimes[lib]
            with open(path) as f:
                src = _fake_cluster(json.load(f))
            snap = ClusterSnapshot(ev, SnapshotConfig())
            runs[cid] = AuditManager(
                client, lister=lambda s=src: iter(s.list()),
                config=AuditConfig(audit_source="snapshot", chunk_size=500,
                                   exact_totals=True),
                evaluator=ev, snapshot=snap).audit()
        _sync(device)
        out["dispatches"] = sum(ev.dispatch_count
                                for _c, _d, ev in runtimes.values())
        for _c, driver, _ev in runtimes.values():
            if driver.gen_coord is not None:
                driver.gen_coord.stop()
    out["wall_s"] = time.perf_counter() - t0
    out["summaries"] = {cid: _canary_summary(r) for cid, r in runs.items()}
    return out


# a canary reference in a child process: argv[1:] = roster spec, device,
# mode, output file
_CANARY_REFERENCE = r"""
import json, sys
import chip_smoke
out = chip_smoke.canary_reference(*sys.argv[1:4])
with open(sys.argv[4], "w") as f:
    json.dump(out, f)
"""


def _canary_proc(argv, name: str) -> tuple:
    """``python ARGV`` as a child process (cwd the checkout), its stderr
    to ``CANARY_DIR/NAME.err``: (Popen, stderr path)."""
    err = os.path.join(CANARY_DIR, name + ".err")
    with open(err, "w") as fh:
        proc = subprocess.Popen([sys.executable, *argv], cwd=ROOT_DIR,
                                stdout=subprocess.DEVNULL, stderr=fh)
    return proc, err


def _canary_wait(label: str, started) -> str:
    """A ``_canary_proc`` child's stderr once it exited 0."""
    proc, err = started
    try:
        proc.wait(timeout=900)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        raise AssertionError(f"canary {label}: the child process hung")
    with open(err) as f:
        text = f.read()
    if proc.returncode != 0:
        raise AssertionError(f"canary {label}: exit {proc.returncode}: "
                             f"{text[-2000:]}")
    return text


def _same_summaries(label: str, got: dict, want: dict) -> None:
    """Per cluster: objects, totals and kept lists equal (exact)."""
    bad = [cid for cid in want if got.get(cid) != want[cid]]
    if set(got) != set(want) or bad:
        cid = (bad or sorted(set(got) ^ set(want)))[0]
        a, b = got.get(cid) or {}, want.get(cid) or {}
        keys = [k for k in set(a.get("totals", {})) | set(
            b.get("totals", {})) if a.get("totals", {}).get(k) !=
            b.get("totals", {}).get(k)]
        raise AssertionError(
            f"canary {label}: cluster {cid} differs (objects "
            f"{a.get('objects')} vs {b.get('objects')}, totals differ at "
            f"{sorted(keys)[:3]}, kept equal "
            f"{a.get('kept') == b.get('kept')}); {len(bad)} clusters "
            f"differ")


def canary_fleet(roster, libraries, device: str, card: str, launches,
                 shapes) -> dict:
    """(a) in process: the roster behind ``FleetEvaluator`` at its
    defaults (chunks of 500, exact totals, ``pack_chunks=0``) on
    ``device``, the runtimes built by the CLI's factory over one disk
    compile cache; one packed pass (fold launches counted), a spill of
    every cluster, a stop and a warm restart from the spills.  Returns the
    record with the pass's per-cluster summaries."""
    from gatekeeper_tpu_torch.drivers import torch_driver
    from gatekeeper_tpu_torch.drivers.generation import CompileCache
    from gatekeeper_tpu_torch.fleet import FleetEvaluator
    from gatekeeper_tpu_torch.fleet.config import library_key
    from gatekeeper_tpu_torch.fleet.run import _build_runtime_factory

    cache = CompileCache(os.path.join(CANARY_DIR, "compile-cache"))
    spill_root = os.path.join(CANARY_DIR, "spill")
    keys = {name: library_key(docs) for name, docs in libraries.items()}

    def builder(lib):
        return _build_runtime_factory(libraries[lib], cache, None,
                                      _fleet_args(device))

    sources = {cid: _fake_cluster(objs) for cid, _lib, objs in roster}
    lowers = [0]
    lower = torch_driver.lower_template

    def counting(*a, **k):
        lowers[0] += 1
        return lower(*a, **k)

    boots = []
    t0 = time.perf_counter()
    torch_driver.lower_template = counting
    fleet = FleetEvaluator(spill_root=spill_root)
    try:
        for cid, lib, _objs in roster:
            before = lowers[0]
            fc = fleet.add_cluster(cid, sources[cid], keys[lib],
                                   builder(lib))
            boots.append((lib, len(fc.runtime.clusters),
                          lowers[0] - before))
    finally:
        torch_driver.lower_template = lower
    t_boot = time.perf_counter() - t0
    shared = [b for b in boots if b[1] > 1]
    first = {lib: n for lib, k, n in boots if k == 1}
    if len(fleet.runtimes()) != 2 or any(n for _l, _k, n in shared) or \
            fleet.shared_boots != len(roster) - 2:
        raise AssertionError(
            f"canary fleet: {len(fleet.runtimes())} runtimes, "
            f"{fleet.shared_boots} shared boots, fresh lowerings of the "
            f"shared boots {[n for _l, _k, n in shared if n]}")
    d0 = sum(rt.evaluator.dispatch_count for rt in fleet.runtimes())
    t0 = time.perf_counter()
    try:
        runs = _fold_counted(fleet.sweep, launches, shapes)(full=True)
        _sync(device)
        wall = time.perf_counter() - t0
        dispatches = sum(rt.evaluator.dispatch_count
                         for rt in fleet.runtimes()) - d0
        packed, unpacked = fleet.packed_dispatches, \
            fleet.unpacked_dispatches
        summaries = {cid: _canary_summary(r) for cid, r in runs.items()}
        bad = [cid for cid, r in runs.items() if r.incomplete]
        if bad or sorted(runs) != sorted(sources):
            raise AssertionError(f"canary fleet: incomplete {bad}")
        t0 = time.perf_counter()
        fleet.spill_all()
    finally:
        fleet.stop()
    t_spill = time.perf_counter() - t0
    # the warm restart: every cluster boots from its spill, the first pass
    # evaluates no row and must give the same verdicts
    fleet2 = FleetEvaluator(spill_root=spill_root)
    t0 = time.perf_counter()
    try:
        for cid, lib, _objs in roster:
            fleet2.add_cluster(cid, sources[cid], keys[lib], builder(lib))
        cold = [cid for cid, fc in fleet2.clusters.items()
                if not fc.warm_booted]
        runs2 = _fold_counted(fleet2.sweep, launches, shapes)(full=None)
        _sync(device)
        evaluated = sum(fc.manager.perf.get("snapshot_rows_evaluated", 0)
                        for fc in fleet2.clusters.values())
    finally:
        fleet2.stop()
    t_warm = time.perf_counter() - t0
    if cold or evaluated:
        raise AssertionError(f"canary fleet restart: cold {cold}, "
                             f"{evaluated} rows evaluated")
    _same_summaries("fleet warm restart", {
        cid: _canary_summary(r) for cid, r in runs2.items()}, summaries)
    violations = sum(sum(s["totals"].values()) for s in summaries.values())
    n_objects = sum(len(o) for _c, _l, o in roster)
    log(f"canary fleet: {len(roster)} clusters, {n_objects} objects over "
        f"{len(fleet.runtimes())} runtimes ({fleet.shared_boots} shared "
        f"boots, fresh lowerings at each library's first boot {first}, "
        f"0 at the others) booted in {t_boot:.3f}s; the packed pass "
        f"{wall:.3f}s ({n_objects / wall:.1f} objects/s, {violations} "
        f"violations): {packed} packed + {unpacked} unpacked dispatches, "
        f"{dispatches} device dispatches; spill {t_spill:.3f}s; warm "
        f"restart and pass {t_warm:.3f}s, 0 rows evaluated, verdicts "
        f"equal ({card})")
    return {"clusters": len(roster), "objects": n_objects,
            "violations": violations, "boot_s": t_boot, "pass_s": wall,
            "objects_per_s": n_objects / wall, "packed": packed,
            "unpacked": unpacked, "dispatches": dispatches,
            "first_boot_lowerings": first, "spill_s": t_spill,
            "warm_restart_s": t_warm, "summaries": summaries}


def _post_json(port: int, path: str, body: dict) -> tuple:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    try:
        conn.request("POST", path, body=json.dumps(body).encode(),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def canary_shadow(device: str, card: str, launches, shapes) -> dict:
    """(b) the shadow canary: CANARY_BODIES admissions posted by 64
    keep-alive clients to ``WebhookServer`` on ``device`` (every batch on
    the grid lane, as the lane's candidate decides them) with a
    capture-mode flight recorder and a ``ShadowLane`` over a candidate
    that carries the constraint denying most of the first 128 bodies at
    ``enforcementAction: dryrun`` (it lacks that deny); then
    ``/debug/shadow``, the port's ``gator replay`` of the capture against
    the same candidate, ``POST /debug/shadow`` promote and the candidate's
    allowed bodies served again.  The constraint is the one that, in the
    CPU handler's answers, most often denies a body alone."""
    from gatekeeper_tpu_torch.observability import flightrec
    from gatekeeper_tpu_torch.replay import core, shadow
    from gatekeeper_tpu_torch.webhook.policy import (Batcher,
                                                     ValidationHandler)
    from gatekeeper_tpu_torch.webhook.server import WebhookServer

    bodies, objs = admission_traffic(CANARY_BODIES)
    namespaces = {o["metadata"]["name"]: o for o in objs
                  if o.get("kind") == "Namespace"}
    t0 = time.perf_counter()
    refs = _cpu_answers(objs, namespaces, bodies)
    cpu_s = time.perf_counter() - t0
    alone: collections.Counter = collections.Counter()
    for allowed, _code, message, _w in refs:
        labels = core.recorded_constraints(message)
        if not allowed and len(labels) == 1:
            alone.update(labels)
    if not alone:
        raise AssertionError("canary shadow: no body is denied by one "
                             "constraint alone")
    drop = alone.most_common(1)[0][0]
    client, _driver, _nt, _nc = _client(objs, device=device)
    cand = library_policy_docs()
    for d in cand:
        if d["kind"] != "ConstraintTemplate" and \
                d["metadata"]["name"] == drop:
            d.setdefault("spec", {})["enforcementAction"] = "dryrun"
    cand += [copy.deepcopy(o) for o in objs
             if o.get("kind") in ("Ingress", "Namespace")]
    f_cand = os.path.join(CANARY_DIR, "candidate.json")
    with open(f_cand, "w") as f:
        json.dump(cand, f)
    cache = os.path.join(CANARY_DIR, "shadow-cache")
    runtime = core.load_candidate(cand, compile_cache_dir=cache,
                                  device=device)
    sink = os.path.join(CANARY_DIR, "served.jsonl")
    rec = flightrec.FlightRecorder(capacity=64, sink_path=sink, capture=True)
    lane_rec = flightrec.FlightRecorder(capacity=2 * len(bodies))
    lane = shadow.ShadowLane(runtime, serving_client=client,
                             candidate_docs=cand, recorder=lane_rec,
                             max_queue=len(bodies)).start()
    batcher = Batcher(client, small_batch=0).start()
    server = WebhookServer(
        validation_handler=ValidationHandler(
            client, namespace_lookup=namespaces.get, batcher=batcher,
            failure_policy="fail"),
        host="127.0.0.1", port=0, batcher=batcher).start()
    try:
        with shadow.activate(lane):
            with flightrec.activate(rec):
                replies, lat, wall = post_concurrently(server.port, bodies)
            rec.close()  # the capture holds the shadowed admissions only
            t0 = time.perf_counter()
            lane.drain(timeout=300)
            drain_s = time.perf_counter() - t0
            status, text = _get(server.port, "/debug/shadow")
            snap = json.loads(text)
            allowed_uids = {e["uid"] for e in lane_rec.snapshot(
                limit=10 * len(bodies))["decisions"]
                if e.get("divergence") == "would_allow"}
            p_status, promoted = _post_json(server.port, "/debug/shadow",
                                            {"action": "promote"})
            again = [b for b in bodies
                     if b["request"]["uid"] in allowed_uids]
            replies2, _lat2, _wall2 = post_concurrently(
                server.port, again, procs=2, conns=8)
    finally:
        drained = server.stop()
        lane.stop()
        rec.close()
        gc_ = getattr(runtime.driver, "gen_coord", None)
        if gc_ is not None:
            gc_.stop()
    lat_ms = sorted(x * 1e3 for x in lat)
    out = {"admissions": len(bodies), "wall_s": wall,
           "admissions_per_s": len(bodies) / wall,
           "p50_ms": lat_ms[len(lat_ms) // 2],
           "p99_ms": lat_ms[min(len(lat_ms) - 1, int(0.99 * len(lat_ms)))],
           "drain_s": drain_s, "dropped_constraint": drop,
           "denied_by_it_alone": alone[drop], "cpu_reference_s": cpu_s,
           "lane": {k: snap[k] for k in (
               "evaluated", "lane_errors", "dropped", "skipped",
               "decisions", "divergences", "candidate_lowering")}}
    log(f"canary shadow: {len(bodies)} admissions in {wall:.3f}s, "
        f"{out['admissions_per_s']:.1f}/s, p50 {out['p50_ms']:.3f} ms, p99 "
        f"{out['p99_ms']:.3f} ms ({LOAD_PROCS * LOAD_CONNS} keep-alive "
        f"clients), the lane drained {drain_s:.3f}s after; candidate "
        f"without {drop}'s deny: {json.dumps(out['lane'])} ({card})")
    _held_against_cpu("canary shadow", objs, namespaces, bodies, replies,
                      refs=refs)
    div = snap["divergences"]
    if status != 200 or tuple(snap) != SHADOW_KEYS or \
            snap["evaluated"] != len(bodies) or snap["lane_errors"] or \
            snap["dropped"] or snap["skipped"] or \
            not div.get("would_allow") or \
            set(div) - {"would_allow", "message"} or not drained:
        raise AssertionError(f"canary shadow: /debug/shadow {status} "
                             f"{text[:2000]}, drained {drained}")
    # the same bodies through gator replay against the same candidate
    replay = _gator_json("canary replay", [
        "--device", device, "replay", "-f", sink, "--candidate", f_cand,
        "-o", "json", "--max-divergences", "100000"],
        launches=launches, shapes=shapes)
    want = {"would_allow": replay["newly_allowed"],
            "would_deny": replay["newly_denied"],
            "message": replay["message_changed"],
            "would_error": replay["errors"]}
    # the constraints that left a recorded deny set: only the one the
    # candidate took out (labels past the recorder's 512-character cut
    # show as joined, in both packages, and are not counted here)
    left = sorted(name for name, e in replay["by_constraint"].items()
                  if e["newly_allowed"])
    if replay["records"] != len(bodies) or \
            {k: v for k, v in want.items() if v} != div or left != [drop]:
        raise AssertionError(
            f"canary shadow: the lane's divergences {div} against gator "
            f"replay's {want} over {replay['records']} records; "
            f"constraints that left a deny set {left}")
    flipped = [r for r in replies2.values() if not r["allowed"]]
    if p_status != 200 or promoted.get("state") != "promoted" or \
            not again or flipped:
        raise AssertionError(
            f"canary shadow promote: {p_status} {promoted}; "
            f"{len(flipped)} of {len(again)} re-served bodies denied")
    log(f"canary shadow: divergences equal gator replay's ({want}, all "
        f"attributed to {drop}); promote {promoted['applied']}: the "
        f"{len(again)} bodies the candidate allowed are now allowed "
        f"({card})")
    out["replay_decisions_per_s"] = replay["decisions_per_s"]
    out["promoted"] = promoted["applied"]
    out["reserved"] = len(again)
    return out


def canary_soak(device: str, card: str, launches, shapes) -> dict:
    """(c) the chaos soak (``fuzz/soak.run_soak``) on ``device``: the
    all-family chaos run with the resident lane, the same concurrent, and
    both seeded bugs on their families.  The collect lane is
    differential: every audit chunk ran both fold kernels."""
    from gatekeeper_tpu_torch.fuzz.soak import run_soak

    cache = os.path.join(CANARY_DIR, "soak-cache")
    runs = {
        "chaos": dict(chaos=True, residency="on"),
        "concurrent": dict(chaos=True, residency="on", concurrent=True),
        "mutate_program": dict(families=["alias_mutators"], chaos=False,
                               inject_bug="mutate_program"),
        "extdata_column": dict(families=["extdata_hostile"], chaos=False,
                               inject_bug="extdata_column"),
    }
    lanes = {"mutate_program": "mutate", "extdata_column": "extdata"}
    out = {}
    for name, kw in runs.items():
        rep = _fold_counted(run_soak, launches, shapes)(
            seed=0, size=1, rounds=1, cache_dir=cache, device=device, **kw)
        cd = rep["collect_differential"]
        out[name] = r = {k: rep[k] for k in (
            "ok", "requests", "answered", "lost_verdicts", "crashes",
            "faults_fired", "resident_uploads", "collect_differential",
            "wall_s")}
        r["divergences"] = [(d["lane"], d["family"])
                            for d in rep["divergences"]]
        log(f"canary soak[{name}]: {json.dumps(r)} ({card})")
        if not cd["chunks"] or cd["ok"] != cd["chunks"]:
            raise AssertionError(f"canary soak[{name}]: collect "
                                 f"differential {cd}")
        if name in lanes:
            family = kw["families"][0]
            if rep["ok"] or (lanes[name], family) not in r["divergences"]:
                raise AssertionError(f"canary soak[{name}]: the seeded bug "
                                     f"was missed: {r['divergences']}")
        elif not rep["ok"] or rep["divergences"] or rep["crashes"] or \
                rep["lost_verdicts"] or not rep["resident_uploads"]:
            raise AssertionError(f"canary soak[{name}]: {json.dumps(r)}")
    return out


def canary_phase(objects, card: str, device: str = "cuda") -> tuple:
    """Fleet mode, the shadow canary and the chaos soak: (launches,
    shapes, record).  (a)'s references run as child processes beside the
    in-process steps: every cluster swept alone by an ``AuditManager`` on
    ``device``, the first CANARY_PREFIX clusters' fleet on the CPU, and
    ``python -m gatekeeper_tpu_torch --fleet-config ROSTER --once`` over
    those clusters on ``device``."""
    import shutil

    from gatekeeper_tpu_torch.replay import shadow

    launches = {"fused_fold": 0, "epilogue": 0}
    shapes = {"fused_fold": collections.Counter(),
              "epilogue": collections.Counter()}
    record: dict = {"walls": {}}
    shutil.rmtree(CANARY_DIR, ignore_errors=True)
    os.makedirs(CANARY_DIR)
    children: dict = {}
    t_phase = t0 = time.perf_counter()

    def step(name: str, t: float) -> float:
        record["walls"][name] = time.perf_counter() - t
        log(f"canary: {name} in {record['walls'][name]:.3f}s")
        return time.perf_counter()

    try:
        roster = canary_roster(objects)
        libraries = canary_libraries()
        files = {}
        for name, docs in libraries.items():
            files[name] = os.path.join(CANARY_DIR, f"library-{name}.json")
            with open(files[name], "w") as f:
                json.dump(docs, f)
        clusters = []
        for cid, lib, objs in roster:
            path = os.path.join(CANARY_DIR, f"objects-{cid}.json")
            with open(path, "w") as f:
                json.dump(objs, f)
            clusters.append([cid, lib, path])
        specs = {"all": clusters, "prefix": clusters[:CANARY_PREFIX]}
        for name, cl in specs.items():
            with open(os.path.join(CANARY_DIR, f"spec-{name}.json"),
                      "w") as f:
                json.dump({"libraries": files, "clusters": cl}, f)
        f_roster = os.path.join(CANARY_DIR, "roster.json")
        with open(f_roster, "w") as f:
            json.dump({"clusters": [{"id": cid, "manifests": [files[lib],
                                                              path]}
                                    for cid, lib, path in
                                    clusters[:CANARY_PREFIX]]}, f)
        for name, spec, dev, mode in (
                ("independent", "all", device, "independent"),
                ("cpu", "prefix", "cpu", "fleet")):
            children[name] = _canary_proc(
                ["-c", _CANARY_REFERENCE,
                 os.path.join(CANARY_DIR, f"spec-{spec}.json"), dev, mode,
                 os.path.join(CANARY_DIR, f"{name}.json")], name)
        children["cli"] = _canary_proc(
            ["-m", "gatekeeper_tpu_torch", "--fleet-config", f_roster,
             "--once", "--device", device], "cli")
        t0 = step("roster and child processes started", t0)
        # (a) the fleet
        record["fleet"] = canary_fleet(roster, libraries, device, card,
                                       launches, shapes)
        summaries = record["fleet"].pop("summaries")
        record["fleet"]["launches_after"] = dict(launches)
        t0 = step("(a) fleet", t0)
        # (b) the shadow canary
        record["shadow"] = canary_shadow(device, card, launches, shapes)
        t0 = step("(b) shadow canary", t0)
        # (c) the chaos soak
        record["soak"] = canary_soak(device, card, launches, shapes)
        t0 = step("(c) chaos soak", t0)
        # (a)'s references
        got = {}
        for name in ("independent", "cpu"):
            _canary_wait(name, children[name])
            with open(os.path.join(CANARY_DIR, f"{name}.json")) as f:
                got[name] = json.load(f)
        cli_err = _canary_wait("cli", children["cli"])
        t0 = step("the child processes' ends", t0)
        _same_summaries("fleet against independent sweeps", summaries,
                        got["independent"]["summaries"])
        prefix = {cid: summaries[cid]
                  for cid, _l, _p in clusters[:CANARY_PREFIX]}
        _same_summaries("fleet against the cpu", got["cpu"]["summaries"],
                        prefix)
        fleet = record["fleet"]
        alone = got["independent"]["dispatches"]
        if alone < 2 * fleet["dispatches"]:
            raise AssertionError(
                f"canary fleet: {fleet['dispatches']} dispatches packed "
                f"against {alone} independent (want 2x fewer)")
        lines = dict(re.findall(
            r"^fleet audit \[(\S+)\]: (\d+ objects, \d+ violations)",
            cli_err, re.M))
        want = {cid: f"{s['objects']} objects, "
                     f"{sum(s['totals'].values())} violations"
                for cid, s in prefix.items()}
        if lines != want:
            raise AssertionError(f"canary fleet CLI: {lines} against "
                                 f"{want}: {cli_err[-2000:]}")
        fleet["independent_dispatches"] = alone
        fleet["independent_wall_s"] = got["independent"]["wall_s"]
        fleet["cpu_prefix_wall_s"] = got["cpu"]["wall_s"]
        log(f"canary fleet: every cluster equals its independent sweep "
            f"({alone} dispatches alone against {fleet['dispatches']} "
            f"packed: {alone / max(1, fleet['dispatches']):.1f}x), the "
            f"first {CANARY_PREFIX} the --device cpu fleet, and the "
            f"--fleet-config CLI printed {lines} ({card})")
    finally:
        for proc, _err in children.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(CANARY_DIR, ignore_errors=True)
    _nothing_installed("canary")
    if shadow.active() is not None:
        raise AssertionError("canary: a shadow lane is left installed")
    record["wall_s"] = time.perf_counter() - t_phase
    record["launches"] = dict(launches)
    log(f"canary: {record['wall_s']:.1f}s; fold launches {launches} at "
        f"(C, N, k) { {k: sorted(v) for k, v in shapes.items()} } ({card})")
    if device == "cuda" and min(launches.values()) <= 0:
        raise AssertionError(f"canary: a fold kernel never launched: "
                             f"{launches}")
    return launches, {k: dict(v) for k, v in shapes.items()}, record


# --- the Evaluate sidecar: rpc/ and drivers/remote.py over the loopback -----
SIDECAR_CHUNK = 32768  # (b): objects per Sweep RPC, the path phase's chunk
SIDECAR_BODIES = 512  # (d): admission bodies through QueryBatch
SIDECAR_BATCH = 64  # (d): reviews per QueryBatch RPC
SIDECAR_THREADS = 4  # (e): sweeps at once
SIDECAR_THREAD_OBJECTS = 8192  # (e): objects of each concurrent sweep
# (e): each collect waits this long first, widening the window in which
# another sweep's submit can run (as the JAX package's test does)
SIDECAR_COLLECT_WAIT_S = 0.05
SIDECAR_DIR = os.path.join(ROOT_DIR, "_sidecar")


class _TimedTransport:
    """A transport wrapper that records each call: its method, request
    and response bytes and its wall (submit to done); with ``keep`` the
    Sweep calls' bytes too, for the codec's timing."""

    def __init__(self, inner):
        self.inner = inner
        self.calls: list = []
        self.kept: list = []  # [(request bytes, response future)]
        self.keep = False
        self._lock = threading.Lock()

    def __call__(self, method: str, request: bytes, timeout=None):
        t0 = time.perf_counter()
        fut = self.inner(method, request, timeout)
        rec = {"method": method, "request_bytes": len(request)}

        def done(f):
            rec["wall_s"] = time.perf_counter() - t0
            if f.exception() is None:
                rec["response_bytes"] = len(f.result())

        fut.add_done_callback(done)
        with self._lock:
            self.calls.append(rec)
            if self.keep and method == "Sweep":
                self.kept.append((request, fut))
        return fut

    def take(self, method: str) -> list:
        with self._lock:
            out = [c for c in self.calls if c["method"] == method]
            self.calls = []
        return out


def sidecar_world(objects, device: str) -> tuple:
    """(servicer, loopback, transport, driver, client): an
    ``EvaluateServicer`` on ``device`` behind ``rpc.sidecar.Loopback``, and
    the control plane's client over it (a ``RemoteDriver`` beside a
    ``CELDriver``, as ``--evaluate-sidecar`` builds them) with the library
    reconciled and the Ingresses of ``objects`` synced (the path phase's
    inventory)."""
    from gatekeeper_tpu_torch.apis.constraints import AUDIT_EP, WEBHOOK_EP
    from gatekeeper_tpu_torch.client.client import Client
    from gatekeeper_tpu_torch.drivers.cel_driver import CELDriver
    from gatekeeper_tpu_torch.drivers.remote import RemoteDriver
    from gatekeeper_tpu_torch.rpc.sidecar import EvaluateServicer, Loopback
    from gatekeeper_tpu_torch.target.target import K8sValidationTarget
    from gatekeeper_tpu_torch.utils.synthetic import load_library

    svc = EvaluateServicer(device=device)
    lb = Loopback(svc)
    transport = _TimedTransport(lb)
    driver = RemoteDriver(transport=transport)
    client = Client(target=K8sValidationTarget(),
                    drivers=[driver, CELDriver()],
                    enforcement_points=[WEBHOOK_EP, AUDIT_EP])
    load_library(client)
    for o in objects:
        if o.get("kind") == "Ingress":
            client.add_data(o)  # referential inventory (uniqueingresshost)
    return svc, lb, transport, driver, client


def sidecar_audit(client, driver, objects, exact: bool, label: str):
    """(run, seconds): the control plane's ``AuditManager`` over
    ``RemoteEvaluator`` (one Sweep RPC per chunk of SIDECAR_CHUNK)."""
    from gatekeeper_tpu_torch.audit.manager import AuditConfig, AuditManager
    from gatekeeper_tpu_torch.drivers.remote import RemoteEvaluator

    mgr = AuditManager(client, lister=lambda: iter(objects),
                       config=AuditConfig(violations_limit=20,
                                          chunk_size=SIDECAR_CHUNK,
                                          exact_totals=exact,
                                          submit_window=4),
                       evaluator=RemoteEvaluator(driver, violations_limit=20,
                                                 exact_totals=exact))
    t0 = time.perf_counter()
    run = mgr.audit()
    dt = time.perf_counter() - t0
    if run.incomplete or run.total_objects != len(objects) or \
            run.n_devices != 0 or mgr.perf.get("pipelined") != 0.0:
        raise AssertionError(
            f"sidecar {label}: incomplete {run.incomplete}, "
            f"{run.total_objects} of {len(objects)} objects, n_devices "
            f"{run.n_devices}, pipelined {mgr.perf.get('pipelined')}")
    return run, dt


def _kept_summary(kept, totals) -> list:
    """A run's verdicts as JSON: [[kind, name, total, [[object kind,
    namespace/name, message], ...]], ...], sorted by constraint, kept
    lists in their order."""
    return [[kind, name, totals[(kind, name)],
             [[v.kind, f"{v.namespace}/{v.name}", v.message]
              for v in kept.get((kind, name), ())]]
            for kind, name in sorted(totals)]


def sidecar_cpu_reference(n_objects: int, prefix: int) -> dict:
    """(c)'s reference: a CPU servicer (``device="cpu"``, the kernels'
    plain versions) behind the loopback, with the inventory of
    ``make_cluster_objects(n_objects, seed=0)`` (the path phase's
    objects), audited at exact totals over the first ``prefix``."""
    from gatekeeper_tpu_torch.utils.synthetic import make_cluster_objects

    objects = make_cluster_objects(n_objects, seed=0)
    t0 = time.perf_counter()
    _svc, lb, _tr, driver, client = sidecar_world(objects, "cpu")
    try:
        run, dt = sidecar_audit(client, driver, objects[:prefix], True,
                                "(c) cpu")
    finally:
        lb.close()
    return {"verdicts": _kept_summary(run.kept, run.total_violations),
            "audit_s": dt, "wall_s": time.perf_counter() - t0}


# (c)'s CPU servicer in a child process (its exact-totals render runs on
# another core beside (a) and (b)): argv[1:] = objects, prefix, out file
_SIDECAR_REFERENCE = r"""
import json, sys
import chip_smoke
ref = chip_smoke.sidecar_cpu_reference(int(sys.argv[1]), int(sys.argv[2]))
with open(sys.argv[3], "w") as f:
    json.dump(ref, f)
"""


def _sidecar_codec(transport) -> dict:
    """Seconds the codec takes on the kept Sweep calls: decode and encode
    of each request and response (both sides' work per RPC)."""
    from gatekeeper_tpu_torch.rpc import evaluate_pb2 as pb

    raw = [(req, fut.result()) for req, fut in transport.kept]
    transport.kept = []
    out = {}
    for side, cls, blobs in (
            ("request", pb.SweepRequest, [r for r, _a in raw]),
            ("response", pb.SweepResponse, [a for _r, a in raw])):
        t0 = time.perf_counter()
        msgs = [cls.FromString(b) for b in blobs]
        out[f"{side}_decode_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        again = [m.SerializeToString() for m in msgs]
        out[f"{side}_encode_s"] = time.perf_counter() - t0
        if again != blobs:
            raise AssertionError(f"sidecar: the codec's {side} bytes do not "
                                 f"round-trip")
    return out


def _query_answers(responses) -> list:
    return [sorted((r.constraint.get("kind", ""),
                    (r.constraint.get("metadata") or {}).get("name", ""),
                    r.msg, json.dumps(r.details, sort_keys=True))
                   for r in qr.results) for qr in responses]


def sidecar_admission(svc, client, driver, label: str) -> dict:
    """(d): SIDECAR_BODIES admission bodies, SIDECAR_BATCH a QueryBatch
    RPC, each answer held against the servicer's ``TorchDriver`` called in
    this process on the same reviews."""
    from gatekeeper_tpu_torch.apis.constraints import WEBHOOK_EP
    from gatekeeper_tpu_torch.drivers.base import ReviewCfg
    from gatekeeper_tpu_torch.match.match import SOURCE_ORIGINAL
    from gatekeeper_tpu_torch.target.review import AugmentedReview
    from gatekeeper_tpu_torch.webhook.policy import parse_admission_review

    bodies, objs = admission_traffic(SIDECAR_BODIES)
    namespaces = {o["metadata"]["name"]: o for o in objs
                  if o.get("kind") == "Namespace"}
    reviews = []
    for body in bodies:
        req = parse_admission_review(body)
        reviews.append(client.target.handle_review(AugmentedReview(
            admission_request=req,
            namespace=namespaces.get(req.namespace) if req.namespace
            else None, source=SOURCE_ORIGINAL, is_admission=True)))
    cfg = ReviewCfg(enforcement_point=WEBHOOK_EP)
    cons = client.constraints()
    local_cons = list(svc._constraints.values())
    got, want, walls = [], [], []
    for i in range(0, len(reviews), SIDECAR_BATCH):
        part = reviews[i:i + SIDECAR_BATCH]
        t0 = time.perf_counter()
        got += _query_answers(driver.query_batch(client.target.name, cons,
                                                 part, cfg))
        walls.append(time.perf_counter() - t0)
        want += _query_answers(svc.driver.query_batch(
            svc.target.name, local_cons, part, cfg))
    diffs = [i for i, (g, w) in enumerate(zip(got, want)) if g != w]
    denied = sum(bool(g) for g in got)
    if diffs or len(got) != len(bodies) or not denied:
        raise AssertionError(f"sidecar {label}: {len(diffs)} of {len(got)} "
                             f"answers differ from the in-process driver "
                             f"(first {diffs[:3]}), {denied} with results")
    return {"bodies": len(bodies), "with_results": denied,
            "rpc_wall_s": walls, "reviews_per_s": len(bodies) / sum(walls)}


def sidecar_concurrent(svc, client, driver, objects, label: str) -> dict:
    """(e): SIDECAR_THREADS threads sweep SIDECAR_THREAD_OBJECTS objects
    each at once: every result equal to its serial sweep, and some RPC's
    submit (the servicer's lock held) overlapping another's collect (the
    lock released)."""
    from gatekeeper_tpu_torch.apis.constraints import AUDIT_EP
    from gatekeeper_tpu_torch.drivers.remote import RemoteEvaluator

    ev = RemoteEvaluator(driver, violations_limit=20)
    cons = [c for c in client.constraints() if c.actions_for(AUDIT_EP)]
    n = SIDECAR_THREAD_OBJECTS
    chunks = [objects[i * n:(i + 1) * n] for i in range(SIDECAR_THREADS)]
    t0 = time.perf_counter()
    serial = [ev.sweep(cons, ch) for ch in chunks]
    serial_s = time.perf_counter() - t0
    spans: list = []  # (phase, thread, t0, t1)
    spans_lock = threading.Lock()
    submit, collect = svc.evaluator.sweep_submit, svc.evaluator.sweep_collect

    def timed(phase, fn):
        def wrapper(*a, **k):
            if phase == "collect":
                time.sleep(SIDECAR_COLLECT_WAIT_S)
            t_in = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                with spans_lock:
                    spans.append((phase, threading.get_ident(), t_in,
                                  time.perf_counter()))
        return wrapper

    results: list = [None] * SIDECAR_THREADS
    errors: list = []

    def run(i):
        try:
            results[i] = ev.sweep(cons, chunks[i])
        except Exception as e:
            errors.append(repr(e))

    svc.evaluator.sweep_submit = timed("submit", submit)
    svc.evaluator.sweep_collect = timed("collect", collect)
    try:
        threads = [threading.Thread(target=run, args=(i,))
                   for i in range(SIDECAR_THREADS)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        concurrent_s = time.perf_counter() - t0
        if any(t.is_alive() for t in threads):
            raise AssertionError(f"sidecar {label}: a sweep thread hangs")
    finally:
        svc.evaluator.sweep_submit = submit
        svc.evaluator.sweep_collect = collect
    if errors:
        raise AssertionError(f"sidecar {label}: {errors}")
    submits = [s for s in spans if s[0] == "submit"]
    collects = [(tid, c0 - SIDECAR_COLLECT_WAIT_S, c1)
                for phase, tid, c0, c1 in spans if phase == "collect"]
    overlaps = sum(st != ct and s0 < c1 and c0 < s1
                   for _p, st, s0, s1 in submits for ct, c0, c1 in collects)
    if not overlaps:
        raise AssertionError(f"sidecar {label}: no submit overlapped "
                             f"another sweep's collect: {spans}")
    bad = [i for i in range(SIDECAR_THREADS) if results[i] != serial[i]]
    if bad:
        raise AssertionError(f"sidecar {label}: concurrent sweeps {bad} "
                             f"differ from their serial sweeps")
    return {"serial_s": serial_s, "concurrent_s": concurrent_s,
            "overlaps": overlaps}


def _importable(name: str) -> str:
    """Whether module ``name`` imports here, and its version."""
    import importlib

    try:
        mod = importlib.import_module(name)
    except ImportError:
        return f"{name} does not import"
    return f"{name} {getattr(mod, '__version__', '?')} imports"


def sidecar_phase(objects, path_ref, path_s: float, card: str,
                  device: str = "cuda") -> tuple:
    """The Evaluate sidecar through its loopback transport: (launches,
    shapes, record).  ``path_ref`` is the path phase's reduced-lane
    (kept, totals), ``path_s`` its wall."""
    import shutil

    from gatekeeper_tpu_torch.audit.manager import AuditManager

    launches = {"fused_fold": 0, "epilogue": 0}
    shapes = {"fused_fold": collections.Counter(),
              "epilogue": collections.Counter()}
    record: dict = {"walls": {}}
    t_phase = t0 = time.perf_counter()

    def step(name: str, t: float) -> float:
        record["walls"][name] = time.perf_counter() - t
        log(f"sidecar: {name} in {record['walls'][name]:.3f}s")
        return time.perf_counter()

    log(f"sidecar: on this host {_importable('grpc')}, "
        f"{_importable('google.protobuf')}; the RPCs ride the loopback "
        f"transport and the port's codec")
    os.makedirs(SIDECAR_DIR, exist_ok=True)
    ref_path = os.path.join(SIDECAR_DIR, "cpu.json")
    child = subprocess.Popen(
        [sys.executable, "-c", _SIDECAR_REFERENCE, str(len(objects)),
         str(CPU_PREFIX), ref_path], cwd=ROOT_DIR, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    # (a) Reconcile and Status
    svc = lb = None
    try:
        svc, lb, transport, driver, client = sidecar_world(objects, device)
        reconciles = transport.take("Reconcile")
        status = driver.dump()
        want_platform = "gpu" if device == "cuda" else "cpu"
        if (status["sidecar"] != {"devices": 1, "platform": want_platform}
                or len(status["lowered"]) != 46 or status["fallback"]):
            raise AssertionError(f"sidecar (a): status {status['sidecar']}, "
                                 f"{len(status['lowered'])} lowered, "
                                 f"fallback {status['fallback']}")
        record["reconcile"] = {
            "rpcs": len(reconciles),
            "wall_s": sum(c.get("wall_s", 0.0) for c in reconciles)}
        transport.take("Status")
        t0 = step(f"(a) {len(reconciles)} Reconcile RPCs (46 templates, their "
                  f"constraints, the Ingresses), status {status['sidecar']}, "
                  f"{len(status['lowered'])} lowered", t0)
        # (b) the audit through the seam, reduced lane
        transport.keep = True
        run, dt = _fold_counted(sidecar_audit, launches, shapes)(
            client, driver, objects, False, "(b)")
        transport.keep = False
        sweeps = transport.take("Sweep")
        diff = AuditManager._verdicts_differ_canonical(
            run.kept, run.total_violations, path_ref[0], path_ref[1], 20)
        if diff:
            raise AssertionError(f"sidecar (b): differs from the path "
                                 f"phase's reduced lane: {diff}")
        # the kept lists hold the same violations in the same order too
        # (both keep each constraint's first 20 in listing order)
        if _kept_summary(run.kept, run.total_violations) != \
                _kept_summary(*path_ref):
            raise AssertionError("sidecar (b): the kept lists differ in "
                                 "order from the path phase's")
        if device == "cuda" and launches["fused_fold"] <= 0:
            raise AssertionError(f"sidecar (b): fused_fold never launched: "
                                 f"{launches}")
        codec = _sidecar_codec(transport)
        record["audit"] = {
            "wall_s": dt, "objects_per_s": run.total_objects / dt,
            "path_objects_per_s": len(objects) / path_s,
            "sweep_rpcs": sweeps, "codec": codec,
            "launches": dict(launches)}
        log(f"sidecar (b): {run.total_objects} objects, "
            f"{sum(run.total_violations.values())} violations in {dt:.3f}s: "
            f"{run.total_objects / dt:.1f} objects/s through the seam "
            f"against {len(objects) / path_s:.1f}/s in process (the path "
            f"phase's reduced lane), equal canonically; launches "
            f"{launches} ({card})")
        for i, c in enumerate(sweeps):
            log(f"sidecar (b) Sweep RPC {i}: {c.get('wall_s', 0.0):.3f}s, "
                f"request {c['request_bytes']} bytes, response "
                f"{c.get('response_bytes')} bytes")
        log(f"sidecar (b) codec: {json.dumps(codec)}")
        t0 = step("(b) the audit through the seam", t0)
        # (c) exact totals on the first CPU_PREFIX objects, card and CPU
        prefix = objects[:CPU_PREFIX]
        before = dict(launches)
        card_run, card_s = _fold_counted(sidecar_audit, launches, shapes)(
            client, driver, prefix, True, "(c)")
        exact_launches = {k: launches[k] - before[k] for k in launches}
        t0 = step("(c) exact totals on the card", t0)
        try:
            _out, err = child.communicate(timeout=900)
        except subprocess.TimeoutExpired:
            raise AssertionError("sidecar (c): the CPU servicer's process "
                                 "hung")
        if child.returncode != 0:
            raise AssertionError(f"sidecar (c): the CPU servicer's process "
                                 f"exited {child.returncode}: "
                                 f"{err[-2000:]}")
        with open(ref_path) as f:
            ref = json.load(f)
        got = json.loads(json.dumps(
            _kept_summary(card_run.kept, card_run.total_violations)))
        if got != ref["verdicts"]:
            raise AssertionError("sidecar (c): the card's exact totals "
                                 "differ from the CPU servicer's")
        record["exact"] = {"card_s": card_s, "cpu_s": ref["audit_s"],
                           "cpu_process_s": ref["wall_s"],
                           "launches": exact_launches}
        log(f"sidecar (c): exact totals over {CPU_PREFIX} objects "
            f"({sum(card_run.total_violations.values())} results) equal "
            f"the CPU servicer's, kept lists in order; card {card_s:.3f}s, "
            f"cpu {ref['audit_s']:.3f}s (its process {ref['wall_s']:.1f}s), "
            f"launches {exact_launches}")
        t0 = step("(c) the CPU servicer's process", t0)
        # (d) admission through QueryBatch
        record["admission"] = _fold_counted(
            sidecar_admission, launches, shapes)(svc, client, driver, "(d)")
        adm = record["admission"]
        log(f"sidecar (d): {adm['bodies']} admission bodies in batches of "
            f"{SIDECAR_BATCH}, every answer equal to the in-process "
            f"driver's ({adm['with_results']} with results); "
            f"{adm['reviews_per_s']:.1f} reviews/s through the seam")
        t0 = step("(d) admission", t0)
        # (e) concurrent sweeps
        record["concurrent"] = _fold_counted(
            sidecar_concurrent, launches, shapes)(svc, client, driver,
                                                  objects, "(e)")
        conc = record["concurrent"]
        log(f"sidecar (e): {SIDECAR_THREADS} sweeps of "
            f"{SIDECAR_THREAD_OBJECTS} objects equal their serial sweeps; "
            f"{conc['overlaps']} submit/collect overlaps; serial "
            f"{conc['serial_s']:.3f}s, concurrent {conc['concurrent_s']:.3f}s")
        t0 = step("(e) concurrent sweeps", t0)
    finally:
        if lb is not None:
            lb.close()
        if child.poll() is None:
            child.kill()
            child.communicate()
        shutil.rmtree(SIDECAR_DIR, ignore_errors=True)
    del svc
    record["wall_s"] = time.perf_counter() - t_phase
    record["launches"] = dict(launches)
    log(f"sidecar: {record['wall_s']:.1f}s; fold launches {launches} at "
        f"(C, N, k) { {k: sorted(v) for k, v in shapes.items()} } ({card})")
    return launches, {k: dict(v) for k, v in shapes.items()}, record


# --- the sweep over a mesh and across processes ------------------------------
MESH_SHARDS = 2          # (a): shards of the in-process mesh on cuda:0
MESH_CHUNK = 32768       # (a), (c): objects a chunk (a shard's in (a))
MESH_SHARD_CHUNKS = 2    # (a), (b): --shard-chunks
MESH_CLI_OBJECTS = 4096  # (b): objects of the CLI processes' manifests
MESH_EXACT_OBJECTS = 1024  # (a): objects of the exact-totals pair (the
                           # host's render bounds it)
MESH_CLI_TIMEOUT_S = 300.0
MESH_DIR = os.path.join(ROOT_DIR, "_mesh")
FOLD_KERNELS = ("fused_fold", "epilogue")


def mesh_audit(objects, device: str, exact: bool, devices=None,
               shard_chunks: int = MESH_SHARD_CHUNKS, per_shard=None,
               warm: bool = False) -> tuple:
    """(run, seconds, evaluator, warm seconds): the library audit of
    ``objects`` on the reduced lane, chunks of MESH_CHUNK, over a mesh of
    ``devices`` (None: one shard on ``device``) with ``shard_chunks``;
    ``per_shard`` (a Counter) receives each shard's fold launches,
    ``warm`` runs ``warm_pass`` over the objects first (the wire
    narrowing)."""
    from gatekeeper_tpu_torch.audit.manager import AuditConfig, AuditManager
    from gatekeeper_tpu_torch.ops import fold
    from gatekeeper_tpu_torch.parallel.mesh import make_mesh
    from gatekeeper_tpu_torch.parallel.sweep import SweepEvaluator

    client, driver, _nt, _nc = _client(objects, device=device)
    mesh = None if devices is None else make_mesh(device=device,
                                                  devices=devices)
    ev = SweepEvaluator(driver, device=device, violations_limit=20,
                        collect="reduced", mesh=mesh)
    if per_shard is not None:
        fold_fn = ev._fold

        def counted(raw, mask, plan, budget, n, shard=0):
            before = {k: getattr(fold, k).launches for k in FOLD_KERNELS}
            part = fold_fn(raw, mask, plan, budget, n, shard)
            for k in FOLD_KERNELS:
                per_shard[(shard, k)] += getattr(fold, k).launches - \
                    before[k]
            return part

        ev._fold = counted
    warm_s = 0.0
    if warm:
        t0 = time.perf_counter()
        ev.warm_pass(client.constraints(), objects, MESH_CHUNK)
        _sync(device)
        warm_s = time.perf_counter() - t0
        ev.perf_reset()
    mgr = AuditManager(client, lister=lambda: iter(objects),
                       config=AuditConfig(violations_limit=20,
                                          chunk_size=MESH_CHUNK,
                                          exact_totals=exact,
                                          submit_window=4,
                                          shard_chunks=shard_chunks),
                       evaluator=ev)
    t0 = time.perf_counter()
    run = mgr.audit()
    _sync(device)
    dt = time.perf_counter() - t0
    _schedule_held(f"mesh audit ({len(objects)} objects)", mgr.perf)
    if run.incomplete or run.total_objects != len(objects) or \
            run.n_devices != ev.mesh.size:
        raise AssertionError(
            f"mesh audit: incomplete {run.incomplete}, {run.total_objects} "
            f"of {len(objects)} objects, n_devices {run.n_devices}")
    return run, dt, ev, warm_s


def _same_verdicts_in_order(label: str, run, ref) -> None:
    """``run`` equals ``ref`` = (kept, totals) canonically and with every
    kept list in its order."""
    from gatekeeper_tpu_torch.audit.manager import AuditManager

    diff = AuditManager._verdicts_differ_canonical(
        run.kept, run.total_violations, ref[0], ref[1], 20)
    if diff:
        raise AssertionError(f"{label}: {diff}")
    if _kept_summary(run.kept, run.total_violations) != \
            _kept_summary(ref[0], ref[1]):
        raise AssertionError(f"{label}: the kept lists differ in order")


def mesh_cli_start(objects, device: str) -> tuple:
    """(b): three ``python -m gatekeeper_tpu_torch --once --shard-chunks
    2`` processes over the library and a manifest of ``objects`` (with a
    Config syncing Ingresses, the audit's inventory): ranks 0 and 1 of
    ``--coordinator 127.0.0.1:P --num-processes 2``, and one process
    alone.  Returns [(name, Popen, start time)]."""
    from gatekeeper_tpu_torch.utils.synthetic import library_dir

    os.makedirs(MESH_DIR, exist_ok=True)
    path = os.path.join(MESH_DIR, "objects.yaml")
    with open(path, "w") as f:
        f.write("\n---\n".join(json.dumps(o)
                               for o in [KUBE_CONFIG, *objects]))
    base = [sys.executable, "-m", "gatekeeper_tpu_torch", "--manifests",
            library_dir(), "--manifests", path, "--once", "--shard-chunks",
            str(MESH_SHARD_CHUNKS)]
    if device == "cpu":
        base += ["--device", "cpu"]
    port = _free_port()
    env = dict(os.environ, GATEKEEPER_DIST_TIMEOUT_S=str(
        int(MESH_CLI_TIMEOUT_S)))
    started = []
    for name, extra in (
            ("rank 0", ["--coordinator", f"127.0.0.1:{port}",
                        "--num-processes", "2", "--process-id", "0"]),
            ("rank 1", ["--coordinator", f"127.0.0.1:{port}",
                        "--num-processes", "2", "--process-id", "1"]),
            ("alone", [])):
        started.append((name, subprocess.Popen(
            base + extra, cwd=ROOT_DIR, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True), time.perf_counter()))
    return started


def mesh_cli_end(started, card: str) -> dict:
    """(b)'s gates: every process exits 0; both ranks join, report a
    2-shard mesh and print the summary of the process alone, byte for
    byte.  Returns each process's wall, audit line and gather share."""
    out: dict = {}
    try:
        for name, proc, t0 in started:
            try:
                stdout, stderr = proc.communicate(
                    timeout=max(1.0, MESH_CLI_TIMEOUT_S
                                - (time.perf_counter() - t0)))
            except subprocess.TimeoutExpired:
                raise AssertionError(f"mesh (b): {name} ran past "
                                     f"{MESH_CLI_TIMEOUT_S}s")
            wall = time.perf_counter() - t0
            if proc.returncode != 0:
                raise AssertionError(f"mesh (b): {name} exited "
                                     f"{proc.returncode}: {stderr[-3000:]}")
            m = re.search(r"audit: (\d+) objects, (\d+) violations in "
                          r"([0-9.]+)s \(flatten_workers=\d+, n_devices=(\d+)"
                          r", shard_chunks=(\d+)\)", stderr)
            if not m:
                raise AssertionError(f"mesh (b): {name} printed no audit "
                                     f"line: {stderr[-3000:]}")
            rec = {"stdout": stdout, "wall_s": wall,
                   "objects": int(m.group(1)), "violations": int(m.group(2)),
                   "audit_s": float(m.group(3)),
                   "n_devices": int(m.group(4)),
                   "shard_chunks": int(m.group(5))}
            joined = [ln for ln in stderr.splitlines()
                      if ln.startswith("joined global mesh")]
            g = re.search(r"mesh gather: (\d+) gathers, ([0-9.]+)s of the "
                          r"audit's ([0-9.]+)s, (\d+) bytes sent", stderr)
            if name != "alone":
                if joined != [f"joined global mesh: process "
                              f"{name[-1]}/2"] or not g \
                        or rec["n_devices"] != 2:
                    raise AssertionError(f"mesh (b): {name}: joined "
                                         f"{joined}, gather line {bool(g)}, "
                                         f"n_devices {rec['n_devices']}")
                rec.update(joined=joined[0], gathers=int(g.group(1)),
                           gather_s=float(g.group(2)),
                           gather_bytes=int(g.group(4)))
            elif joined or g or rec["n_devices"] != 1:
                raise AssertionError(f"mesh (b): the process alone joined "
                                     f"a mesh: {stderr[-2000:]}")
            out[name] = rec
    finally:
        for _name, proc, _t0 in started:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    alone = out["alone"]
    for name in ("rank 0", "rank 1"):
        rec = out[name]
        if (rec["stdout"], rec["objects"], rec["violations"]) != \
                (alone["stdout"], alone["objects"], alone["violations"]):
            raise AssertionError(f"mesh (b): {name}'s summary differs from "
                                 f"the process alone's")
        log(f"mesh (b): {rec['joined']}; wall {rec['wall_s']:.3f}s, audit "
            f"{rec['audit_s']:.3f}s, {rec['gathers']} gloo gathers "
            f"{rec['gather_s']:.3f}s ({rec['gather_s'] / rec['wall_s']:.4f} "
            f"of the wall, {rec['gather_s'] / max(rec['audit_s'], 1e-9):.4f}"
            f" of the audit), {rec['gather_bytes']} bytes sent; "
            f"{rec['objects']} objects, {rec['violations']} violations")
    if alone["violations"] <= 0 or alone["stdout"].count("\n") < 100:
        raise AssertionError("mesh (b): the summary is not sane")
    log(f"mesh (b): both ranks printed the summary of the process alone "
        f"({alone['objects']} objects, {alone['violations']} violations, "
        f"{alone['stdout'].count(chr(10))} kept lines; its wall "
        f"{alone['wall_s']:.3f}s, audit {alone['audit_s']:.3f}s) ({card})")
    for rec in out.values():
        del rec["stdout"]
    return out


def mesh_phase(objects, path_ref, path_s: float, deep, deep_ref, card: str,
               device: str = "cuda") -> tuple:
    """The sweep over a device mesh and across processes: (launches,
    shapes, record).  ``path_ref``: the path phase's reduced-lane (kept,
    totals), ``path_s`` its wall; ``deep_ref``: the depth relist's
    reduced-lane (kept, totals, (seconds, phases))."""
    import shutil

    from gatekeeper_tpu_torch.ops import fold

    launches = {k: 0 for k in FOLD_KERNELS}
    shapes = {k: collections.Counter() for k in FOLD_KERNELS}
    record: dict = {"walls": {}}
    t_phase = t0 = time.perf_counter()

    def step(name: str, t: float) -> float:
        record["walls"][name] = time.perf_counter() - t
        log(f"mesh: {name} in {record['walls'][name]:.3f}s")
        return time.perf_counter()

    on_card = ["cuda:0"] * MESH_SHARDS if device == "cuda" \
        else ["cpu"] * MESH_SHARDS
    # (a) a 2-shard mesh on one card over the path phase's objects: no
    # torch.topk may run (the plain fold); every shard folds every chunk
    topk_calls = [0]
    real_topk = torch.topk

    def counted_topk(*args, **kwargs):
        topk_calls[0] += 1
        return real_topk(*args, **kwargs)

    meshes = [("a", on_card)]
    if device == "cuda" and torch.cuda.device_count() > 1:
        meshes.append(("a, every card", [f"cuda:{i}" for i in range(
            torch.cuda.device_count())]))
    started = []
    try:
        # (b) the CLI across two processes and alone, beside (a) and (c):
        # its boots and exact-totals passes are the phase's longest wall
        started = mesh_cli_start(objects[:MESH_CLI_OBJECTS], device)
        for label, devices in meshes:
            per_shard = collections.Counter()
            torch.topk = counted_topk
            try:
                run, dt, ev, _w = _fold_counted(mesh_audit, launches,
                                                shapes)(
                    objects, device, False, devices, per_shard=per_shard)
            finally:
                torch.topk = real_topk
            _same_verdicts_in_order(f"mesh ({label})", run, path_ref)
            d = len(devices)
            for s in range(d):
                got = per_shard[(s, "fused_fold")] + \
                    per_shard[(s, "epilogue")]
                if device == "cuda" and (
                        got != ev.dispatch_count
                        or per_shard[(s, "fused_fold")] <= 0):
                    raise AssertionError(
                        f"mesh ({label}): shard {s} folded {got} of "
                        f"{ev.dispatch_count} dispatches: {dict(per_shard)}")
            if device == "cuda" and topk_calls[0]:
                raise AssertionError(f"mesh ({label}): torch.topk ran "
                                     f"{topk_calls[0]} times")
            record[f"({label})"] = {
                "shards": d, "wall_s": dt, "path_wall_s": path_s,
                "dispatches": ev.dispatch_count,
                "per_shard": {f"{s}/{k}": v
                              for (s, k), v in sorted(per_shard.items())},
                "upload_s": ev.perf.get("upload", 0.0),
                "h2d_bytes": ev.perf.get("h2d_bytes", 0.0),
                "fallbacks": ev.perf.get("collect_fallbacks", 0.0)}
            log(f"mesh ({label}): {d} shards, shard_chunks "
                f"{MESH_SHARD_CHUNKS}: {run.total_objects} objects, "
                f"{sum(run.total_violations.values())} violations in "
                f"{dt:.3f}s against the path phase's {path_s:.3f}s, equal "
                f"to its verdicts in order; {ev.dispatch_count} dispatches, "
                f"launches per shard {record[f'({label})']['per_shard']} at "
                f"(C, N/D, k) { {k: sorted(v) for k, v in shapes.items()} }"
                f", torch.topk calls {topk_calls[0]} ({card})")
            del run, ev
            t0 = step(f"({label}) the reduced lane over {d} shards", t0)
        # (c) the wire narrowing: warm_pass over the depth objects, then
        # their reduced-lane relist with the corpus stats, then the same
        # relist without them (both beside (b)); the depth relist ran
        # without them alone
        run, dt, ev, warm_s = _fold_counted(mesh_audit, launches, shapes)(
            deep, device, False, None, shard_chunks=0, warm=True)
        _same_verdicts_in_order("mesh (c)", run, deep_ref)
        keys = ("wire_bytes", "h2d_bytes", "upload", "wire_pack")
        narrow = {k: ev.perf.get(k, 0.0) for k in keys}
        n_stats = len(ev._col_stats)
        del run, ev
        run, plain_s, ev, _w = _fold_counted(mesh_audit, launches, shapes)(
            deep, device, False, None, shard_chunks=0)
        _same_verdicts_in_order("mesh (c) without narrowing", run, deep_ref)
        wide = {k: ev.perf.get(k, 0.0) for k in keys}
        depth_s, depth = deep_ref[2]
        alone = {k: depth.get(k, 0.0) for k in keys}
        if not narrow["wire_bytes"] < wide["wire_bytes"]:
            raise AssertionError(f"mesh (c): wire bytes {narrow} against "
                                 f"{wide} (the depth relist {alone})")
        record["(c)"] = {"warm_pass_s": warm_s, "wall_s": dt,
                         "plain_wall_s": plain_s, "narrowed": narrow,
                         "plain": wide, "depth_wall_s": depth_s,
                         "depth": alone, "col_stats": n_stats}
        log(f"mesh (c): warm_pass over {len(deep)} objects in "
            f"{warm_s:.3f}s; the narrowed relist {dt:.3f}s against "
            f"{plain_s:.3f}s without narrowing (the depth relist alone "
            f"{depth_s:.3f}s), both equal to its verdicts in order; "
            f"wire_bytes {narrow['wire_bytes']:.0f} against "
            f"{wide['wire_bytes']:.0f}, h2d_bytes {narrow['h2d_bytes']:.0f} "
            f"against {wide['h2d_bytes']:.0f}, upload {narrow['upload']:.3f}"
            f"s against {wide['upload']:.3f}s (alone {alone['upload']:.3f}"
            f"s), wire_pack {narrow['wire_pack']:.3f}s against "
            f"{wide['wire_pack']:.3f}s; {n_stats} column stats ({card})")
        del run, ev
        t0 = step("(c) the wire narrowing", t0)
        # (a) exact totals over a prefix, on the mesh and on one device
        prefix = objects[:MESH_EXACT_OBJECTS]
        per_shard = collections.Counter()
        exact, dt_mesh, _ev, _w = _fold_counted(mesh_audit, launches,
                                                shapes)(
            prefix, device, True, on_card, per_shard=per_shard)
        alone, dt_alone, _ev, _w = mesh_audit(prefix, device, True,
                                              shard_chunks=0)
        if summary(exact) != summary(alone):
            raise AssertionError("mesh (a): exact totals over the mesh "
                                 "differ from one device's")
        record["(a) exact"] = {"objects": len(prefix), "wall_s": dt_mesh,
                               "alone_s": dt_alone,
                               "per_shard": {f"{s}/{k}": v for (s, k), v
                                             in sorted(per_shard.items())}}
        log(f"mesh (a): exact totals over {len(prefix)} objects "
            f"({sum(exact.total_violations.values())} results) on "
            f"{MESH_SHARDS} shards equal one device's, kept lists in order; "
            f"{dt_mesh:.3f}s against {dt_alone:.3f}s; launches per shard "
            f"{record['(a) exact']['per_shard']}")
        del exact, alone, _ev
        t0 = step("(a) exact totals on both", t0)
        record["(b)"] = mesh_cli_end(started, card)
        started = []
        t0 = step("(b) the two-process CLI", t0)
    finally:
        torch.topk = real_topk
        for _name, proc, _t in started:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        shutil.rmtree(MESH_DIR, ignore_errors=True)
    record["wall_s"] = time.perf_counter() - t_phase
    record["launches"] = dict(launches)
    log(f"mesh: {record['wall_s']:.1f}s; fold launches {launches} at "
        f"(C, N, k) { {k: sorted(v) for k, v in shapes.items()} } ({card})")
    return launches, {k: dict(v) for k, v in shapes.items()}, record


def _stop_resource_tracker() -> None:
    """End the resource tracker that spawning the kube phase's children
    started (it would outlive the script by a moment otherwise); call it
    once every spawned child has exited."""
    from multiprocessing import resource_tracker

    stop = getattr(resource_tracker._resource_tracker, "_stop", None)
    if stop is not None:
        stop()


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--objects", type=int, default=131072,
                   help="synthetic cluster objects (131,072 = 4 chunks; up "
                        "to 1,000,000)")
    p.add_argument("--admissions", type=int, default=1024,
                   help="AdmissionReviews a phase serves, at most (the "
                        "admission phase serves ADMISSION_BODIES of them, "
                        "the mutate phase all)")
    args = p.parse_args()
    if not 0 < args.objects <= 1_000_000:
        raise SystemExit("--objects must be in 1..1,000,000")
    if args.admissions < 1:
        raise SystemExit("--admissions must be positive")
    t_start = time.perf_counter()

    def phase(name):
        log(f"== {name} (at {time.perf_counter() - t_start:.1f}s)")

    phase("device")
    card = device_phase()["card"]
    phase("kernels")
    rows, err = kernel_phase()
    # the kube phase's CLI: started by the hooks phase once its (a) is over
    cli_runs: list = []
    try:
        return run_phases(args, card, rows, err, cli_runs, t_start, phase)
    finally:
        for cli_run in cli_runs:
            cli_run.stop()
        _stop_resource_tracker()


def run_phases(args, card: str, rows, err, cli_runs: list,
               t_start: float, phase) -> int:
    """Phases 3-21 (see the module docstring)."""
    phase("path")
    launches, shapes, objects, relist_runs, prefix_summary, timings = \
        path_phase(args.objects)
    # the sidecar phase's reference: the reduced lane's verdicts and wall
    path_reduced = (relist_runs["reduced"].kept,
                    dict(relist_runs["reduced"].total_violations))
    path_reduced_s = timings["reduced"][0]
    deep, deep_runs, deep_timings = depth_references(objects, relist_runs,
                                                     timings)
    del relist_runs
    # the mesh phase's (c) reference: the depth relist's reduced lane
    deep_reduced = (deep_runs["reduced"].kept,
                    dict(deep_runs["reduced"].total_violations),
                    deep_timings["reduced"])
    plain_totals = {c: dict(run.total_violations)
                    for c, run in deep_runs.items()}
    phase("pipeline")
    pipe_launches, pipe_shapes, pipe_records = pipeline_phase(
        deep, deep_runs, prefix_summary, card)
    gc.collect()
    phase("snapshot")
    snap_launches, snap_shapes, snap_steps = snapshot_phase(
        deep, deep_runs, card)
    del deep_runs
    gc.collect()  # the snapshot worlds' reference cycles, before timing on
    phase("expand")
    exp_launches, exp_shapes, exp_steps = expand_phase(deep, plain_totals,
                                                       card)
    gc.collect()
    phase("extdata")
    ext_launches, ext_shapes, ext_steps = extdata_phase(
        deep, args.admissions, card)
    gc.collect()
    phase("lifecycle")
    life_launches, life_shapes, life_record = lifecycle_phase(
        objects, card, n_bodies=min(LIFE_BODIES, args.admissions))
    gc.collect()
    phase("hooks")
    hook_launches, hook_shapes, hook_record = hooks_phase(
        deep, card, n_bodies=min(HOOKS_BODIES, args.admissions),
        after_served=lambda: cli_runs.append(
            KubeCliRun(min(args.objects, KUBE_OBJECTS))))
    gc.collect()
    phase("kube")
    # (a)'s references: the in-memory dict relist of the apiserver's objects
    kube_objects = objects[:KUBE_OBJECTS]
    kube_relists = {c: audit(kube_objects, "cuda", c)
                    for c in ("reduced", "masks")}
    kube_launches, kube_shapes, kube_record = kube_phase(
        kube_objects,
        {c: (run.kept, dict(run.total_violations))
         for c, (run, _p, _dt) in kube_relists.items()},
        {c: (dt, phases) for c, (_run, phases, dt) in kube_relists.items()},
        life_record, cli_runs[0], card,
        n_bodies=min(KUBE_BODIES, args.admissions))
    del kube_relists
    gc.collect()
    phase("gator")
    gator_launches, gator_shapes, gator_record = gator_phase(objects, card)
    gc.collect()
    phase("canary")
    canary_launches, canary_shapes, canary_record = canary_phase(objects,
                                                                 card)
    gc.collect()
    phase("sidecar")
    side_launches, side_shapes, side_record = sidecar_phase(
        objects, path_reduced, path_reduced_s, card)
    gc.collect()
    phase("mesh")
    mesh_launches, mesh_shapes, mesh_record = mesh_phase(
        objects, path_reduced, path_reduced_s, deep, deep_reduced, card)
    gc.collect()
    phase("shapes")
    shape_phase(rows, err, {
        name: dict(collections.Counter(shapes[name])
                   + collections.Counter(pipe_shapes[name])
                   + collections.Counter(snap_shapes[name])
                   + collections.Counter(exp_shapes[name])
                   + collections.Counter(ext_shapes.get(name, {}))
                   + collections.Counter(life_shapes[name])
                   + collections.Counter(hook_shapes[name])
                   + collections.Counter(kube_shapes[name])
                   + collections.Counter(gator_shapes[name])
                   + collections.Counter(canary_shapes[name])
                   + collections.Counter(side_shapes[name])
                   + collections.Counter(mesh_shapes[name]))
        for name in shapes})
    phase("profile")
    profile_phase(deep)
    del objects, deep
    phase("admission")
    admission_phase(min(ADMISSION_BODIES, args.admissions), card)
    phase("served")
    served_phase(min(SERVED_ADMISSIONS, args.admissions), SERVED_OBJECTS,
                 card)
    phase("mutate")
    mutate = mutate_phase(args.admissions, card)
    log(f"snapshot steps: {json.dumps(snap_steps)}")
    log(f"expand steps: {json.dumps(exp_steps)}")
    log(f"mutate: {json.dumps(mutate)}")
    log(f"extdata steps: {json.dumps(ext_steps, default=str)}")
    log(f"pipeline runs: {json.dumps(pipe_records, default=str)}")
    log(f"lifecycle: {json.dumps(life_record, default=str)}")
    log(f"hooks: {json.dumps(hook_record, default=str)}")
    log(f"kube: {json.dumps(kube_record, default=str)}")
    log(f"gator: {json.dumps(gator_record, default=str)}")
    log(f"canary: {json.dumps(canary_record, default=str)}")
    log(f"sidecar: {json.dumps(side_record, default=str)}")
    log(f"mesh: {json.dumps(mesh_record, default=str)}")
    log(f"chip_smoke: {time.perf_counter() - t_start:.1f}s in all")
    log(card)
    for row in rows:
        row["launches"] = launches[row["name"]]
        row["pipeline_launches"] = pipe_launches[row["name"]]
        row["snapshot_launches"] = snap_launches[row["name"]]
        row["expand_launches"] = exp_launches[row["name"]]
        row["extdata_launches"] = ext_launches[row["name"]]
        row["lifecycle_launches"] = life_launches[row["name"]]
        row["hooks_launches"] = hook_launches[row["name"]]
        row["kube_launches"] = kube_launches[row["name"]]
        row["gator_launches"] = gator_launches[row["name"]]
        row["canary_launches"] = canary_launches[row["name"]]
        row["sidecar_launches"] = side_launches[row["name"]]
        row["mesh_launches"] = mesh_launches[row["name"]]
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
