"""gator CLI: offline enforcement points.

Reference: cmd/gator/gator.go (cobra root with subcommands
test / verify / expand / sync / bench / policy).  Usage:

    python -m gatekeeper_tpu_torch.gator [--device cuda|cpu] \
        test -f <file-or-dir> [...]

The global ``--device`` (default ``cuda``) is where the commands that put
work on the device run it: ``bench`` (engines ``tpu``, ``sweep``,
``mutate``), ``expand`` (lanes ``batched``, ``differential``) and
``replay``.  They raise without a CUDA card unless ``--device cpu`` is
given; the other commands run only the interpreters and ignore it.
"""

from __future__ import annotations

import argparse
import json
import sys

import yaml

from gatekeeper_tpu_torch.gator import reader


def _enforceable_failure(result) -> bool:
    # Reference: cmd/gator/test/test.go:245-255.
    if result.enforcement_action == "deny":
        return True
    return "deny" in (result.scoped_enforcement_actions or [])


def _format_results(results, output: str, stats_entries=None) -> str:
    if output in ("json", "yaml"):
        payload = [
            {
                "target": r.target,
                "msg": r.msg,
                "constraint": r.constraint,
                "metadata": r.metadata,
                "enforcementAction": r.enforcement_action,
                "scopedEnforcementActions": r.scoped_enforcement_actions,
                "violatingObject": r.violating_object,
            }
            for r in results
        ]
        if stats_entries:
            payload = {
                "results": payload,
                "stats": [
                    {
                        "scope": s.scope,
                        "statsFor": s.stats_for,
                        "stats": [
                            {"name": st.name, "value": st.value, "source": st.source}
                            for st in s.stats
                        ],
                    }
                    for s in stats_entries
                ],
            }
        if output == "json":
            return json.dumps(payload, indent=4, default=str)
        return yaml.safe_dump(payload, sort_keys=False)
    # human friendly (reference: cmd/gator/test/test.go:203-230)
    lines = []
    for r in results:
        obj = r.violating_object or {}
        api_version = obj.get("apiVersion", "")
        kind = obj.get("kind", "")
        meta = obj.get("metadata") or {}
        name, ns = meta.get("name", ""), meta.get("namespace", "")
        if ns:
            head = f"{api_version}/{kind} {ns}/{name}"
        else:
            head = f"{api_version}/{kind} {name}"
        cname = (r.constraint.get("metadata") or {}).get("name", "")
        lines.append(f'{head}: ["{cname}"] Message: "{r.msg}"')
    return "\n".join(lines) + ("\n" if lines else "")


def cmd_test(argv: list[str]) -> int:
    p = argparse.ArgumentParser(prog="gator test")
    p.add_argument("--filename", "-f", action="append", default=[])
    p.add_argument("--output", "-o", default="")
    p.add_argument("--trace", "-t", action="store_true")
    p.add_argument("--stats", action="store_true")
    p.add_argument("--enable-k8s-native-validation",
                   action=argparse.BooleanOptionalAction, default=True)
    p.add_argument("--deny-only", action="store_true")
    args = p.parse_args(argv)

    try:
        objs = reader.read_sources(args.filename, use_stdin=not args.filename)
    except OSError as e:
        print(f"error: reading: {e}", file=sys.stderr)
        return 1
    if not objs:
        print("no input data identified", file=sys.stderr)
        return 1

    from gatekeeper_tpu_torch.gator.test import test as gator_test

    try:
        responses = gator_test(
            objs,
            include_cel=args.enable_k8s_native_validation,
            tracing=args.trace,
            stats=args.stats,
        )
    except Exception as e:  # template/constraint/review errors -> clean exit
        print(f"error: auditing objects: {e}", file=sys.stderr)
        return 1
    results = responses.results()
    if args.deny_only:
        results = [r for r in results if _enforceable_failure(r)]
    out = _format_results(results, args.output,
                          responses.stats_entries if args.stats else None)
    if out:
        print(out, end="" if out.endswith("\n") else "\n")
    return 1 if any(_enforceable_failure(r) for r in results) else 0


def _delegate(module: str):
    def run(argv: list[str]) -> int:
        import importlib

        name = f"gatekeeper_tpu_torch.gator.{module}"
        try:
            mod = importlib.import_module(name)
        except ModuleNotFoundError as e:
            if e.name != name:
                raise  # a real bug inside the module, not a missing command
            print(
                f"error: gator {module} is not available in this build",
                file=sys.stderr,
            )
            return 2
        return mod.run_cli(argv)

    return run


cmd_verify = _delegate("verify")
cmd_expand = _delegate("expand_cmd")
cmd_bench = _delegate("bench")
cmd_sync = _delegate("sync_cmd")
cmd_policy = _delegate("policy_cmd")
cmd_decisions = _delegate("decisions_cmd")
cmd_generate_vap = _delegate("generate_vap_cmd")
cmd_replay = _delegate("replay_cmd")
cmd_triage = _delegate("triage_cmd")


COMMANDS = {
    "test": cmd_test,
    "verify": cmd_verify,
    "expand": cmd_expand,
    "bench": cmd_bench,
    "sync": cmd_sync,
    "policy": cmd_policy,
    "decisions": cmd_decisions,
    "generate-vap": cmd_generate_vap,
    "replay": cmd_replay,
    "triage": cmd_triage,
}


# the commands that take --device (each also accepts it after its name)
DEVICE_COMMANDS = ("bench", "expand", "replay")
USAGE = ("usage: gator [--chaos spec.json] [--device cuda|cpu] "
         "{test|verify|expand|bench|sync|policy|decisions|"
         "generate-vap|replay|triage} [options]")


def _global_flag(argv: list, name: str) -> tuple:
    """(value, argv without it) of a global ``--name VALUE`` /
    ``--name=VALUE`` that comes before the command."""
    value = None
    out = []
    it = iter(argv)
    for a in it:
        if value is None and not out and a == name:
            value = next(it, "")
        elif value is None and not out and a.startswith(name + "="):
            value = a.split("=", 1)[1]
        else:
            out.append(a)
    return value, out


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(USAGE)
        return 0
    # global --chaos spec.json: install the deterministic fault-injection
    # plan before any subcommand runs (README 'Failure semantics')
    stripped = []
    chaos = ""
    it = iter(argv)
    for a in it:
        if a == "--chaos":
            chaos = next(it, "")
        elif a.startswith("--chaos="):
            chaos = a.split("=", 1)[1]
        else:
            stripped.append(a)
    device, argv = _global_flag(stripped, "--device")
    if device is not None and device not in ("cuda", "cpu"):
        print(f"--device must be cuda or cpu, not {device!r}",
              file=sys.stderr)
        return 2
    if chaos:
        from gatekeeper_tpu_torch.resilience import faults

        faults.install(faults.load_chaos_spec(chaos))
        print(f"chaos harness active: {chaos}", file=sys.stderr)
    if not argv:
        print(USAGE)
        return 0
    cmd = argv[0]
    fn = COMMANDS.get(cmd)
    if fn is None:
        print(f"unknown command {cmd!r}", file=sys.stderr)
        return 2
    rest = argv[1:]
    if device is not None and cmd in DEVICE_COMMANDS:
        rest = ["--device", device] + rest
    try:
        return fn(rest)
    except BrokenPipeError:
        # downstream pager/head closed the pipe; exit quietly like kubectl
        try:
            sys.stderr.close()
        except Exception:
            pass
        return 1


if __name__ == "__main__":
    sys.exit(main())
