"""Audit source ``relist``: every sweep lists the cluster anew.

The lister pages the cluster's JSON bytes, serialized in set-up, as
``RawJSON`` objects: each sweep gets fresh wrappers over the same bytes, as
each LIST gets fresh pages from the apiserver, so the program's raw flatten
lane does the parsing.
"""


def build(stack: dict, raws: list, cfg, mix: dict) -> None:
    from gatekeeper_tpu_torch.audit.manager import AuditManager
    from gatekeeper_tpu_torch.utils.rawjson import RawJSON

    stack["mgr"] = AuditManager(
        stack["client"], lister=lambda: (RawJSON(b) for b in raws),
        config=cfg, evaluator=stack["evaluator"])
