"""List and route (``audit/manager.py`` ``_chunk_source``): the manager's
``perf["list_route"]``, the seconds from each resume of the chunk source
to its yield (the lister's pages, the kind peek, the router and the
generator tee; the consumer's time left out), over the window's objects,
in microseconds an object."""


def read(layer):
    s = layer.get("mgr_perf", {}).get("list_route")
    if not s or not layer.get("objects"):
        return None
    return s / layer["objects"] * 1e6
