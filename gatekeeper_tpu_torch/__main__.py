"""Offline audit entry point of the port.

    python -m gatekeeper_tpu_torch --manifests DIR --once \
        [--collect reduced|masks] [--device cuda|cpu] \
        [--constraint-violations-limit N]

Loads ConstraintTemplates, constraints and cluster objects from YAML
(files or directories, ``--manifests`` repeatable), runs one audit sweep on
the device and prints the same summary (stderr) and kept-violation lines
(stdout) as ``python -m gatekeeper_tpu --manifests DIR --once``.

Every manifest object is audited, templates and constraints included.  The
JAX package's CLI runs its controller plane and also audits the status
objects it writes (one ConstraintTemplatePodStatus per template); the port
has no controller plane yet, so its object count leaves those out.  A
``Config`` named ``config`` with ``spec.sync.syncOnly`` syncs the listed
kinds into ``data.inventory``; its other fields are not read.  CEL-only
templates are skipped with a warning (the CEL engine is not ported yet).
"""

from __future__ import annotations

import argparse
import sys

TEMPLATES_GROUP = "templates.gatekeeper.sh"
CONSTRAINTS_GROUP = "constraints.gatekeeper.sh"
CONFIG_GROUP = "config.gatekeeper.sh"


def load_manifests(paths) -> list:
    """Manifest objects in apply order, deduplicated by (gvk, namespace,
    name): a re-applied object keeps its first position and its last
    content, as an apiserver store would."""
    from gatekeeper_tpu_torch.sync.source import FileSource
    from gatekeeper_tpu_torch.utils.unstructured import (gvk_of, name_of,
                                                         namespace_of)

    store: dict = {}
    for obj in FileSource(*paths).objects:
        if isinstance(obj, dict):
            store[(gvk_of(obj), namespace_of(obj), name_of(obj))] = obj
    return list(store.values())


def build_client(objects):
    """(client, driver) with every template and constraint of
    ``objects`` installed and the Config-synced inventory loaded."""
    from gatekeeper_tpu_torch.apis.constraints import AUDIT_EP, WEBHOOK_EP
    from gatekeeper_tpu_torch.client.client import Client
    from gatekeeper_tpu_torch.drivers.torch_driver import TorchDriver
    from gatekeeper_tpu_torch.target.target import K8sValidationTarget
    from gatekeeper_tpu_torch.utils.unstructured import gvk_of, name_of

    driver = TorchDriver()
    client = Client(target=K8sValidationTarget(), drivers=[driver],
                    enforcement_points=[WEBHOOK_EP, AUDIT_EP])
    sync: set = set()
    for obj in objects:
        group, _v, kind = gvk_of(obj)
        if group == TEMPLATES_GROUP and kind == "ConstraintTemplate":
            try:
                client.add_template(obj)
            except Exception as e:
                print(f"template {name_of(obj)} skipped: {e}",
                      file=sys.stderr)
        elif group == CONFIG_GROUP and kind == "Config" \
                and name_of(obj) == "config":
            for e in ((obj.get("spec") or {}).get("sync") or {}).get(
                    "syncOnly") or []:
                sync.add((e.get("group", ""), e.get("version", ""),
                          e.get("kind", "")))
    for obj in objects:
        if gvk_of(obj)[0] == CONSTRAINTS_GROUP:
            try:
                client.add_constraint(obj)
            except Exception as e:
                print(f"constraint {name_of(obj)} skipped: {e}",
                      file=sys.stderr)
    for obj in objects:
        if gvk_of(obj) in sync:
            client.add_data(obj)
    return client, driver


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m gatekeeper_tpu_torch")
    p.add_argument("--manifests", action="append", default=[],
                   help="YAML file or directory (repeatable)")
    p.add_argument("--once", action="store_true",
                   help="run one audit sweep and exit (the only mode "
                        "ported so far)")
    p.add_argument("--collect", default="reduced",
                   choices=("reduced", "masks"),
                   help="what a sweep chunk brings back from the device")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="cuda (default) runs the hand-written kernels; cpu "
                        "runs their plain PyTorch versions")
    p.add_argument("--constraint-violations-limit", type=int, default=20)
    args = p.parse_args(argv)
    if not args.once:
        print("only --once is supported by the port so far", file=sys.stderr)
        return 2

    from gatekeeper_tpu_torch.audit.manager import AuditConfig, AuditManager
    from gatekeeper_tpu_torch.parallel.sweep import SweepEvaluator

    objects = load_manifests(args.manifests)
    client, driver = build_client(objects)
    print(f"templates: {len(client.templates())} "
          f"({len(driver.lowered_kinds())} on the device verdict path), "
          f"constraints: {len(client.constraints())}", file=sys.stderr)
    evaluator = SweepEvaluator(
        driver, device=args.device,
        violations_limit=args.constraint_violations_limit,
        collect=args.collect)
    mgr = AuditManager(
        client, lister=lambda: iter(objects),
        config=AuditConfig(
            violations_limit=args.constraint_violations_limit),
        evaluator=evaluator)
    run = mgr.audit()
    total = sum(run.total_violations.values())
    print(f"audit: {run.total_objects} objects, {total} violations "
          f"in {run.duration_s:.2f}s "
          f"(flatten_workers={run.flatten_workers}, "
          f"n_devices={run.n_devices}, "
          f"shard_chunks={run.shard_chunks})"
          + (f" [INCOMPLETE: {run.failed_chunks} chunks dropped, "
             f"{run.retried_chunks} retried]" if run.incomplete
             else ""), file=sys.stderr)
    for key, kept in sorted(run.kept.items()):
        for v in kept:
            print(f"  {key[0]}/{key[1]}: {v.kind} "
                  f"{v.namespace + '/' if v.namespace else ''}{v.name}: "
                  f"{v.message}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
