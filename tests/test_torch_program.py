"""The port's grid evaluator (gatekeeper_tpu_torch/ir/program.py) against
the JAX package's ``CompiledProgram``: for every template of ``library/``
(44 Rego, 2 CEL, each side with its CEL driver) the [C, N] verdict grids must be bit-equal on the same numpy
inputs (the JAX package's parameter table and batch columns, handed to the
port through ``ir.convert.tensors_from_numpy``).  Each template runs with
its sample constraint plus two variants (no parameters; altered
parameters), so the constraint axis is wider than one, over the library's
sample objects and a seeded synthetic cluster.  One more case runs the
port's own lowering + flatten end to end."""

import copy
import glob
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from gatekeeper_tpu.apis.constraints import AUDIT_EP, WEBHOOK_EP  # noqa: E402
from gatekeeper_tpu.apis.constraints import Constraint as JConstraint  # noqa
from gatekeeper_tpu.client.client import Client as JClient  # noqa: E402
from gatekeeper_tpu.drivers.cel_driver import \
    CELDriver as JCELDriver  # noqa: E402
from gatekeeper_tpu.drivers.tpu_driver import TpuDriver  # noqa: E402
from gatekeeper_tpu.ir import program as jprog  # noqa: E402
from gatekeeper_tpu.ops.flatten import Flattener as JFlattener  # noqa: E402
from gatekeeper_tpu.target.target import \
    K8sValidationTarget as JTarget  # noqa: E402
from gatekeeper_tpu.utils.synthetic import \
    load_library as jload  # noqa: E402
from gatekeeper_tpu.utils.synthetic import make_cluster_objects  # noqa: E402
from gatekeeper_tpu.utils.unstructured import load_yaml_file  # noqa: E402
from gatekeeper_tpu_torch.client.client import Client as TClient  # noqa
from gatekeeper_tpu_torch.drivers.cel_driver import \
    CELDriver as TCELDriver  # noqa: E402
from gatekeeper_tpu_torch.drivers.torch_driver import TorchDriver  # noqa
from gatekeeper_tpu_torch.ir import program as tprog  # noqa: E402
from gatekeeper_tpu_torch.ir.convert import tensors_from_numpy  # noqa: E402
from gatekeeper_tpu_torch.ops.flatten import \
    Flattener as TFlattener  # noqa: E402
from gatekeeper_tpu_torch.target.target import \
    K8sValidationTarget as TTarget  # noqa: E402
from gatekeeper_tpu_torch.utils.synthetic import \
    load_library as tload  # noqa: E402

LIB = os.path.join(os.path.dirname(__file__), "..", "library")
PAD_N = 1024


def _template_kinds():
    kinds = []
    for path in sorted(glob.glob(os.path.join(LIB, "*", "*",
                                              "template.yaml"))):
        doc = load_yaml_file(path)[0]
        kinds.append(doc["spec"]["crd"]["spec"]["names"]["kind"])
    return kinds


@pytest.fixture(scope="module")
def lib():
    jcel, tcel = JCELDriver(), TCELDriver()
    jd = TpuDriver(cel_driver=jcel)
    jc = JClient(target=JTarget(), drivers=[jd, jcel],
                 enforcement_points=[WEBHOOK_EP, AUDIT_EP])
    td = TorchDriver(cel_driver=tcel)
    tc = TClient(target=TTarget(), drivers=[td, tcel],
                 enforcement_points=[WEBHOOK_EP, AUDIT_EP])
    assert jload(jc) == tload(tc) == (46, 46)
    # identical intern order (the CEL lowering's constants included): the
    # port's lowered constants and the JAX package's numpy tables name the
    # same string ids
    assert td.vocab._to_str == jd.vocab._to_str
    samples = []
    for path in sorted(glob.glob(os.path.join(LIB, "*", "*", "samples",
                                              "example_*.yaml"))):
        samples.extend(d for d in load_yaml_file(path)
                       if isinstance(d, dict))
    objects = samples + make_cluster_objects(PAD_N - len(samples) - 24,
                                             seed=11)
    for o in objects:
        if o.get("kind") == "Ingress":
            jc.add_data(o)
            tc.add_data(o)
    return jd, jc, td, tc, objects


def _constraints(jc, kind):
    """The sample constraint plus a no-parameter and an altered-parameter
    variant of it."""
    c0 = next(c for c in jc.constraints() if c.kind == kind)
    params = copy.deepcopy(c0.parameters) \
        if isinstance(c0.parameters, dict) else {}
    for key, v in list(params.items()):
        if isinstance(v, list) and v:
            params[key] = v[:1]
        elif isinstance(v, (int, float)) and not isinstance(v, bool):
            params[key] = v * 2 + 1
        elif isinstance(v, str):
            params[key] = v + "x"
    return [c0,
            JConstraint(kind=kind, name="no-params", match=c0.match,
                        parameters={}, enforcement_action="deny"),
            JConstraint(kind=kind, name="altered", match=c0.match,
                        parameters=params, enforcement_action="deny")]


@pytest.mark.parametrize("kind", _template_kinds())
def test_library_grid_matches_jax(lib, kind):
    jd, jc, td, _tc, objects = lib
    assert kind in jd.lowered_kinds() and kind in td.lowered_kinds()
    jp, tp = jd._programs[kind], td._programs[kind]
    batch = JFlattener(jp.program.schema, jd.vocab).flatten(objects,
                                                            pad_n=PAD_N)
    table = jprog.build_param_table(jp.program, _constraints(jc, kind),
                                    jd.vocab)
    cols = jprog.slim_cols(jprog.pack_batch_cols(batch),
                           jprog.needed_fields(jp.program))
    cols.update(jprog.vocab_tables(jp.program, jd.vocab))
    cols.update(jd.inventory_cols(kind)[0])
    want = np.asarray(jp._fn(table, jax.tree.map(jax.numpy.asarray, cols)))
    params, tcols = tensors_from_numpy(table, cols, "cpu")
    got = tp.grid(params, tcols, PAD_N).numpy()
    assert got.dtype == np.bool_ and got.shape == want.shape == (3, PAD_N)
    assert np.array_equal(got, want)


def test_port_lowering_and_flatten_end_to_end(lib):
    """The port's own lowering, flatten, parameter table and run() give the
    JAX package's grids for every lowered template."""
    jd, jc, td, tc, objects = lib
    for kind in jd.lowered_kinds():
        jp, tp = jd._programs[kind], td._programs[kind]
        jb = JFlattener(jp.program.schema, jd.vocab).flatten(
            objects, pad_n=PAD_N)
        tb = TFlattener(tp.program.schema, td.vocab).flatten(
            objects, pad_n=PAD_N)
        jcons = [c for c in jc.constraints() if c.kind == kind]
        tcons = [c for c in tc.constraints() if c.kind == kind]
        want = jp.run(jb, jprog.build_param_table(jp.program, jcons,
                                                  jd.vocab),
                      vocab=jd.vocab, extra_cols=jd.inventory_cols(kind)[0])
        got = tp.run(tb, tprog.build_param_table(tp.program, tcons,
                                                 td.vocab),
                     vocab=td.vocab, extra_cols=td.inventory_cols(kind)[0],
                     device="cpu")
        assert np.array_equal(got, want), kind
