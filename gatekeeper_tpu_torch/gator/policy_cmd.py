"""gator policy: policy-library package manager.

Reference: pkg/gator/policy/ (search/install/upgrade against a catalog,
artifacts fetched via ORAS OCI pull, pkg/oci/oci.go:27).  Here the catalog
is a YAML index and artifact refs resolve to:

- a bundle directory (template.yaml + samples/ + suite.yaml),
- a .tar / .tar.gz bundle, or
- an OCI image-layout directory (oci-layout + index.json + blobs/...,
  the on-disk format ORAS produces) whose layers are tar(.gz) bundles.

Network refs (http/https/oci://) are recognized but refused: this build
runs without egress; mirror the artifact locally and point the catalog at
the mirror.

Catalog format:

    policies:
      - name: requiredlabels
        description: Requires resources to contain specified labels.
        versions:
          - version: 1.1.2
            ref: bundles/requiredlabels-1.1.2.tar.gz

Installed state is tracked in <target>/.gator-policies.yaml.
"""

from __future__ import annotations

import io
import json
import os
import shutil
import tarfile

import yaml

STATE_FILE = ".gator-policies.yaml"


class PolicyError(Exception):
    pass


# --- catalog ---------------------------------------------------------------


def load_catalog(path: str) -> list:
    if path.startswith(("http://", "https://", "oci://")):
        raise PolicyError(
            f"remote catalog {path!r} not supported in this build (no "
            "network egress); mirror it locally and pass the file path"
        )
    if os.path.isdir(path):
        path = os.path.join(path, "catalog.yaml")
    with open(path) as f:
        doc = yaml.safe_load(f) or {}
    entries = doc.get("policies") or []
    for e in entries:
        if not e.get("name"):
            raise PolicyError("catalog entry without a name")
        e.setdefault("versions", [])
    return entries


def _resolve(entries: list, name: str, version: str = ""):
    for e in entries:
        if e["name"] != name:
            continue
        versions = e["versions"]
        if not versions:
            raise PolicyError(f"catalog entry {name!r} has no versions")
        if not version:
            return e, versions[-1]  # catalog order: last = latest
        for v in versions:
            if str(v.get("version")) == version:
                return e, v
        raise PolicyError(f"{name!r} has no version {version!r}")
    raise PolicyError(f"policy {name!r} not found in catalog")


# --- artifact unpack -------------------------------------------------------


def _extract_tar(fileobj, dest: str) -> None:
    with tarfile.open(fileobj=fileobj, mode="r:*") as tf:
        for member in tf.getmembers():
            # refuse path traversal
            target = os.path.normpath(os.path.join(dest, member.name))
            if not target.startswith(os.path.abspath(dest)):
                raise PolicyError(f"unsafe path in bundle: {member.name}")
        try:
            tf.extractall(dest, filter="data")
        except TypeError:  # Python < 3.12: no filter argument
            tf.extractall(dest)


def _unpack_oci_layout(layout_dir: str, dest: str) -> None:
    """Minimal OCI image-layout reader: index.json -> manifest -> layers
    (each a tar or tar.gz bundle)."""
    with open(os.path.join(layout_dir, "index.json")) as f:
        index = json.load(f)
    manifests = index.get("manifests") or []
    if not manifests:
        raise PolicyError("OCI layout with no manifests")

    def blob(digest: str) -> str:
        algo, hexd = digest.split(":", 1)
        return os.path.join(layout_dir, "blobs", algo, hexd)

    with open(blob(manifests[0]["digest"])) as f:
        manifest = json.load(f)
    layers = manifest.get("layers") or []
    if not layers:
        raise PolicyError("OCI manifest with no layers")
    for layer in layers:
        with open(blob(layer["digest"]), "rb") as f:
            _extract_tar(io.BytesIO(f.read()), dest)


# Transport plug (reference: the ORAS client behind pkg/oci/oci.go:27).
# A deployment with egress registers real fetchers here — e.g.
#   REMOTE_TRANSPORTS["oci://"] = my_oras_pull  # (ref, dest) -> None
# and fetch_bundle routes through them; this build ships only the
# refusing stubs because the environment has no network egress.
REMOTE_TRANSPORTS: dict = {}


def _refuse_remote(ref: str, dest: str) -> None:
    raise PolicyError(
        f"remote artifact {ref!r} not supported in this build (no "
        "network egress); mirror it locally"
    )


for _scheme in ("http://", "https://", "oci://"):
    REMOTE_TRANSPORTS.setdefault(_scheme, _refuse_remote)


def fetch_bundle(ref: str, catalog_dir: str, dest: str) -> None:
    """Materialize the bundle at ``ref`` (relative to the catalog) into
    ``dest`` so that dest/template.yaml exists."""
    for scheme, fetch in REMOTE_TRANSPORTS.items():
        if ref.startswith(scheme):
            fetch(ref, dest)
            return
    src = ref if os.path.isabs(ref) else os.path.join(catalog_dir, ref)
    if not os.path.exists(src):
        raise PolicyError(f"artifact {src!r} does not exist")
    os.makedirs(dest, exist_ok=True)
    if os.path.isdir(src):
        if os.path.exists(os.path.join(src, "index.json")):
            _unpack_oci_layout(src, dest)
        else:
            shutil.copytree(src, dest, dirs_exist_ok=True)
    else:
        with open(src, "rb") as f:
            _extract_tar(f, dest)
    # bundles may nest a single top-level dir; flatten it
    if not os.path.exists(os.path.join(dest, "template.yaml")):
        subdirs = [d for d in os.listdir(dest)
                   if os.path.isdir(os.path.join(dest, d))]
        if len(subdirs) == 1 and os.path.exists(
                os.path.join(dest, subdirs[0], "template.yaml")):
            inner = os.path.join(dest, subdirs[0])
            for item in os.listdir(inner):
                shutil.move(os.path.join(inner, item),
                            os.path.join(dest, item))
            os.rmdir(inner)
    if not os.path.exists(os.path.join(dest, "template.yaml")):
        raise PolicyError("bundle does not contain template.yaml")


# --- installed-state tracking ---------------------------------------------


def _state_path(target: str) -> str:
    return os.path.join(target, STATE_FILE)


def load_state(target: str) -> dict:
    try:
        with open(_state_path(target)) as f:
            return yaml.safe_load(f) or {}
    except FileNotFoundError:
        return {}


def save_state(target: str, state: dict) -> None:
    os.makedirs(target, exist_ok=True)
    with open(_state_path(target), "w") as f:
        yaml.safe_dump(state, f, sort_keys=True)


# --- operations ------------------------------------------------------------


def search(catalog: str, term: str = "") -> list:
    entries = load_catalog(catalog)
    term = term.lower()
    out = []
    for e in entries:
        hay = f"{e['name']} {e.get('description', '')}".lower()
        if term and term not in hay:
            continue
        latest = (e["versions"][-1].get("version", "?")
                  if e["versions"] else "?")
        out.append((e["name"], str(latest), e.get("description", "")))
    return out


def install(catalog: str, name: str, target: str, version: str = "",
            upgrade: bool = False) -> str:
    entries = load_catalog(catalog)
    entry, ver = _resolve(entries, name, version)
    vstr = str(ver.get("version", "?"))
    state = load_state(target)
    cur = state.get(name, {}).get("version")
    if cur is not None and not upgrade:
        raise PolicyError(
            f"{name!r} {cur} already installed (use upgrade)")
    if cur == vstr and upgrade:
        return f"{name} {vstr} already up to date"
    catalog_dir = os.path.dirname(os.path.abspath(
        catalog if not os.path.isdir(catalog)
        else os.path.join(catalog, "catalog.yaml")))
    dest = os.path.join(target, name)
    if os.path.exists(dest):
        shutil.rmtree(dest)
    fetch_bundle(ver.get("ref", ""), catalog_dir, dest)
    state[name] = {"version": vstr, "ref": ver.get("ref", "")}
    save_state(target, state)
    verb = "upgraded to" if cur else "installed"
    return f"{name} {verb} {vstr}"


def remove(target: str, name: str) -> str:
    state = load_state(target)
    if name not in state:
        raise PolicyError(f"{name!r} is not installed")
    dest = os.path.join(target, name)
    if os.path.exists(dest):
        shutil.rmtree(dest)
    del state[name]
    save_state(target, state)
    return f"{name} removed"


def list_installed(target: str) -> list:
    state = load_state(target)
    return sorted((n, str(v.get("version", "?")))
                  for n, v in state.items())


# --- CLI -------------------------------------------------------------------


def run_cli(argv) -> int:
    import argparse
    import sys

    p = argparse.ArgumentParser(
        prog="gator policy",
        description="policy-library package manager (local catalogs + "
                    "OCI image layouts; remote refs refused: no egress)")
    psub = p.add_subparsers(dest="policy_cmd", required=True)

    sp = psub.add_parser("search", help="search the catalog")
    sp.add_argument("term", nargs="?", default="")
    sp.add_argument("--catalog", required=True)

    ip = psub.add_parser("install", help="install a policy bundle")
    ip.add_argument("name")
    ip.add_argument("--catalog", required=True)
    ip.add_argument("--target", default="library")
    ip.add_argument("--version", default="")

    up = psub.add_parser("upgrade", help="upgrade an installed policy")
    up.add_argument("name")
    up.add_argument("--catalog", required=True)
    up.add_argument("--target", default="library")
    up.add_argument("--version", default="")

    rp = psub.add_parser("remove", help="remove an installed policy")
    rp.add_argument("name")
    rp.add_argument("--target", default="library")

    lp = psub.add_parser("list", help="list installed policies")
    lp.add_argument("--target", default="library")

    args = p.parse_args(argv)
    try:
        if args.policy_cmd == "search":
            rows = search(args.catalog, args.term)
            for name, ver, desc in rows:
                print(f"{name}\t{ver}\t{desc}")
            if not rows:
                print("no policies matched", file=sys.stderr)
        elif args.policy_cmd == "install":
            print(install(args.catalog, args.name, args.target,
                          args.version))
        elif args.policy_cmd == "upgrade":
            print(install(args.catalog, args.name, args.target,
                          args.version, upgrade=True))
        elif args.policy_cmd == "remove":
            print(remove(args.target, args.name))
        elif args.policy_cmd == "list":
            for name, ver in list_installed(args.target):
                print(f"{name}\t{ver}")
    except PolicyError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    return 0
