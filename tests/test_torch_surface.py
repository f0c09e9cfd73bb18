"""The port's public surface against the JAX package's, read with `ast`.

For every module of `carta1_tpu/` (parsed, never imported: importing it
loads JAX), each public function and class with its parameter names, and
each upper-case constant, must have a counterpart in the module of
`carta1_tpu_torch/` at the same relative path (or where `MOVED` says)
that accepts every one of those parameter names, so that keyword callers
work; or it is in `DELIBERATE`, with the reason it is left out.  The port
may add parameters of its own (`device`, `plain`, `to_i16`).  No entry of
`DELIBERATE` may have a counterpart, so the list cannot go stale.

Positional callers work too: the JAX package's positional parameters of
each function and class, less those in `DELIBERATE`, are a prefix, in
order, of the counterpart's (an entry `name[order]` records a different
positional contract).  Return annotations agree, `jax.Array` and
`jnp.ndarray` reading as `torch.Tensor`, except where `RETURNS` records
the departure and why.

Each public class's members are held too: every public method, property,
static and class method, and `__getitem__` / `__len__` / `__iter__` where
the JAX class defines them, must exist on the counterpart class and take
the JAX keywords, or stand in `DELIBERATE` as `("module", "Class.member")`.
One case per module of the JAX package for each of the four; no JAX
function is compiled.
"""

from __future__ import annotations

import ast
import importlib
import inspect
import pathlib
import re

import pytest
import torch

JAX_ROOT = pathlib.Path(__file__).resolve().parent.parent / "carta1_tpu"
_UPPER = re.compile(r"^[A-Z][A-Z0-9_]*$")

# where the port put a name under another module or name: (JAX module, name) -> (port module, name)
MOVED = {
    ("ops.exact_fft_pallas", "imdct_exact_pallas"): ("ops.imdct_kernels", "imdct_mid"),
    ("ops.exact_qmf_pallas", "qmf_taps_pallas"): ("ops.qmf_kernels", "qmf_taps"),
    ("ops.bitpack_pallas", "window_reduce_pallas"): ("ops.bitpack_kernels", "read_fields"),
}
# JAX modules whose names live in another module of the port: a Pallas
# kernel's module in its CUDA kernel's wrapper module
MOVED_MODULES = {
    "ops.tables": "tables",
    "ops.exact_fft_pallas": "ops.imdct_kernels",
    "ops.exact_qmf_pallas": "ops.qmf_kernels",
    "ops.bitpack_pallas": "ops.bitpack_kernels",
}

# what the port leaves out on purpose: (JAX module, "*" for the whole module,
# "name", "name(param)" or "Class.member") -> why
DELIBERATE = {
    ("jaxtools", "*"): "the JAX runtime's relay workarounds (hoisted jit, fetch spools); a GPU needs none",
    ("jaxsetup", "*"): "JAX platform and compilation-cache setup",
    ("ops.df", "*"): "f64 emulated by f32 error-free expansions; the H100 has IEEE f64",
    ("native", "*"): "OpenMP host packers with a NumPy fallback; the port packs and unpacks on the card, "
    "byte-equal for every n_bfu (tests/test_torch_pack.py::test_pack_every_bfu_amount_matches_host_pack)",
    ("io.bitstream_np", "*"): "host bit packers; the port packs and unpacks on the card (ops/bitpack.py), "
    "byte-equal for every n_bfu (tests/test_torch_pack.py::test_pack_every_bfu_amount_matches_host_pack)",
    ("pipeline.decoder", "decode_step(short_cap)"): "a static capacity of short frames for one XLA program",
    ("pipeline.decoder", "decode_step(assume_fits)"): "skips the static-capacity overflow fallback",
    ("pipeline.decoder", "auto_short_cap"): "picks the static short-frame capacity of an XLA program",
    ("ops.exact_decode", "imdct_bands_exact(short_cap)"): "a static capacity of short frames for one XLA program",
    ("ops.exact_decode", "imdct_bands_exact(assume_fits)"): "skips the static-capacity overflow fallback",
    ("ops.exact_decode", "imdct_exact_xla"): "the XLA route of K1's core; the port has K1 and its plain version",
    ("ops.exact_decode", "fft_exact"): "the XLA route's FFT in f32 expansions; K1 runs the FFT in f64",
    ("ops.common", "fmatmul"): "a one-hot matmul standing in for a gather; the port indexes",
    ("ops.common", "FP"): "the matmul precision of the one-hot contractions",
    ("ops.coding", "table_lookup"): "a one-hot contraction standing in for a gather; the port indexes",
    ("ops.tables", "bfu_permutation_matrices"): "one-hot matrices standing in for gathers; the port indexes",
    ("parallel.sharding", "make_mesh(axis)"): "a JAX mesh axis name; a port mesh is a tuple of devices",
    ("parallel.sharding", "AXIS"): "the JAX mesh axis name",
    ("ops.exact_fft_pallas", "imdct_exact_pallas(interpret)"): "Pallas interpret mode; a CUDA kernel has "
    "none, its plain version runs for a CPU tensor",
    ("ops.exact_fft_pallas", "imdct_exact_pallas(mid)"): "K1 computes the middle half only; the full "
    "output is ops.exact_decode.imdct_exact(mid=False)",
    ("ops.exact_qmf_pallas", "qmf_taps_pallas(interpret)"): "Pallas interpret mode; a CUDA kernel has "
    "none, its plain version runs for a CPU tensor",
    ("ops.bitpack_pallas", "window_reduce_pallas(h)"): "K3 reads each field at its bit offset and width "
    "(read_fields(win32, offsets, widths, ...)), not a window at an anchor index",
    ("ops.bitpack_pallas", "window_reduce_pallas(block_frames)"): "the TPU grid's block; K3's is fixed",
    ("ops.bitpack_pallas", "window_reduce_pallas[order]"): "K3 takes each field's bit offset and width, "
    "read_fields(win32, offsets, widths, j_lo, j_hi), where the TPU kernel takes anchor indices "
    "(win32, h, j_lo, j_hi); a call in the JAX order raises (test_k3_rejects_a_jax_order_call)",
}

# JAX modules whose functions return tensors where the JAX package's return
# NumPy arrays: np.ndarray in their return annotations reads as torch.Tensor
NUMPY_AS_TENSOR = {
    m: "the gold functions run on the kernels: they take and return tensors where gold uses NumPy arrays"
    for m in ("gold.coding", "gold.decoder", "gold.encoder", "gold.fftjs", "gold.transforms", "gold.transient")
}
# return annotations that depart from the JAX package's on purpose (after
# NUMPY_AS_TENSOR): (JAX module, name) -> (the port's annotation, why)
RETURNS = {
    **{("gold.transforms", f): ("np.ndarray", "the f64 basis is a host table, NumPy as in gold")
       for f in ("mdct_basis", "imdct_basis")},
    ("processor", "decode_units"): ("torch.Tensor", "the PCM stays on the device it was decoded on (int16 "
                                    "with to_i16); the JAX package fetches a NumPy array"),
    ("parallel.sharding", "encode_frames_sharded"): ("tuple[FrameData, dict]", "the state after the last "
                                                     "frame comes back too, so that chunks carry it"),
    ("parallel.sharding", "decode_frames_sharded"): ("tuple[torch.Tensor, dict]", "the state after the last "
                                                     "frame comes back too, so that chunks carry it"),
    ("ops.tables", "encoder_mdct_tables"): ("dict[str, np.ndarray]", "NumPy matrices, moved to a device "
                                            "by their users; the JAX package keeps tuples of them"),
}
_JAX_ARRAY = re.compile(r"\b(?:jax\.Array|jnp\.ndarray|jax\.numpy\.ndarray)\b")


def _params(fn: ast.FunctionDef) -> tuple[list[str], list[str]]:
    """(every parameter name, the positional ones)."""
    a = fn.args
    pos = [p.arg for p in a.posonlyargs + a.args]
    return pos + [p.arg for p in a.kwonlyargs], pos


def jax_surface(path: pathlib.Path) -> dict[str, tuple[str, list[str], list[str], str | None]]:
    """name -> (kind, parameter names, positional parameter names, return
    annotation or None) of a module's public functions and classes (a
    class's `__init__` parameters, or its annotated fields, which a
    dataclass takes in order), upper-case constants and `__all__` names."""
    out: dict[str, tuple[str, list[str], list[str], str | None]] = {}
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) and not node.name.startswith("_"):
            out[node.name] = ("function", *_params(node), ast.unparse(node.returns) if node.returns else None)
        elif isinstance(node, ast.ClassDef) and not node.name.startswith("_"):
            init = [n for n in node.body if isinstance(n, ast.FunctionDef) and n.name == "__init__"]
            fields = [n.target.id for n in node.body if isinstance(n, ast.AnnAssign) and isinstance(n.target, ast.Name)]
            params, pos = (p[1:] for p in _params(init[0])) if init else (fields, fields)
            out[node.name] = ("class", params, pos, None)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            names = [n for t in targets for n in ([t] if isinstance(t, ast.Name) else getattr(t, "elts", []))]
            for n in names:
                if isinstance(n, ast.Name) and _UPPER.match(n.id):
                    out[n.id] = ("constant", [], [], None)
                elif isinstance(n, ast.Name) and n.id == "__all__":
                    for e in node.value.elts:
                        out.setdefault(e.value, ("export", [], [], None))
    return out


_DUNDERS = ("__getitem__", "__len__", "__iter__")


def jax_members(path: pathlib.Path) -> dict[str, dict[str, tuple[str, list[str]]]]:
    """class -> {member: (kind, parameter names without self or cls)} of a
    module's public classes: each public method, property, static and class
    method, and `_DUNDERS` where the class defines them."""
    out: dict[str, dict[str, tuple[str, list[str]]]] = {}
    for node in ast.parse(path.read_text()).body:
        if not isinstance(node, ast.ClassDef) or node.name.startswith("_"):
            continue
        members = {}
        for fn in node.body:
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if fn.name.startswith("_") and fn.name not in _DUNDERS:
                continue
            decorators = {ast.unparse(d) for d in fn.decorator_list}
            kind = next((k for k in ("property", "staticmethod", "classmethod") if k in decorators), "method")
            params = _params(fn)[0]
            members[fn.name] = (kind, params if kind == "staticmethod" else params[1:])
        out[node.name] = members
    return out


def _module_name(path: pathlib.Path) -> str:
    parts = path.relative_to(JAX_ROOT).with_suffix("").parts
    return ".".join(parts[:-1] if parts[-1] == "__init__" else parts)


JAX_MODULES = sorted(_module_name(p) for p in JAX_ROOT.rglob("*.py"))


def _jax_path(module: str) -> pathlib.Path:
    base = JAX_ROOT.joinpath(*module.split(".")) if module else JAX_ROOT
    return base / "__init__.py" if base.is_dir() else base.with_suffix(".py")


def _port_module(module: str):
    name = MOVED_MODULES.get(module, module)
    try:
        return importlib.import_module("carta1_tpu_torch" + ("." + name if name else ""))
    except ModuleNotFoundError:
        return None


def _accepts(obj, params: list[str]) -> list[str]:
    """The names of `params` that a call of obj cannot take as keywords."""
    sig = inspect.signature(obj)
    if any(p.kind == p.VAR_KEYWORD for p in sig.parameters.values()):
        return []
    return [p for p in params
            if p not in sig.parameters or sig.parameters[p].kind == inspect.Parameter.POSITIONAL_ONLY]


def _counterpart(module: str, name: str):
    port_mod, port_name = MOVED.get((module, name), (MOVED_MODULES.get(module, module), name))
    try:
        mod = importlib.import_module("carta1_tpu_torch" + ("." + port_mod if port_mod else ""))
    except ModuleNotFoundError:
        return None
    return getattr(mod, port_name, None)


@pytest.mark.parametrize("module", JAX_MODULES, ids=lambda m: m or "__init__")
def test_port_has_every_public_name_of_the_jax_module(module):
    if (module, "*") in DELIBERATE:
        assert _port_module(module) is None, f"{module} is in DELIBERATE but the port has it"
        return
    assert _port_module(module) is not None, f"the port has no module for carta1_tpu.{module}"
    faults = []
    for name, (kind, params, _, _) in jax_surface(_jax_path(module)).items():
        if (module, name) in DELIBERATE:
            continue
        obj = _counterpart(module, name)
        if obj is None:
            faults.append(f"{kind} {name}: no counterpart")
            continue
        if kind in ("function", "class"):
            left = [p for p in _accepts(obj, params) if (module, f"{name}({p})") not in DELIBERATE]
            if left:
                faults.append(f"{kind} {name}: takes no keyword {left}")
    assert not faults, f"carta1_tpu.{module}: " + "; ".join(faults)


def _member_faults(module: str) -> list[str]:
    """What the counterpart classes of the JAX module's public classes lack:
    a member, or a keyword of one (less the DELIBERATE members)."""
    faults = []
    for cls, members in jax_members(_jax_path(module)).items():
        port_cls = _counterpart(module, cls)
        if (module, cls) in DELIBERATE or not inspect.isclass(port_cls):
            continue                  # left out, or a missing name, which the keyword case reports
        for name, (kind, params) in members.items():
            if (module, f"{cls}.{name}") in DELIBERATE:
                continue
            obj = inspect.getattr_static(port_cls, name, None)
            if obj is None:
                faults.append(f"{kind} {cls}.{name}: no counterpart")
            elif kind == "property":
                if not isinstance(obj, property):
                    faults.append(f"property {cls}.{name}: the port's is no property")
            elif left := _accepts(getattr(port_cls, name), params):
                faults.append(f"{kind} {cls}.{name}: takes no keyword {left}")
    return faults


@pytest.mark.parametrize("module", JAX_MODULES, ids=lambda m: m or "__init__")
def test_port_classes_have_every_public_member_of_the_jax_classes(module):
    """A method, property or static method a user of a `carta1_tpu` class
    calls (`FrameData.zeros`, `AeaMetadata.frames_per_channel`, ...) exists
    on the port's class and takes the same keywords."""
    if (module, "*") in DELIBERATE:
        return
    faults = _member_faults(module)
    assert not faults, f"carta1_tpu.{module}: " + "; ".join(faults)


def test_deliberate_entries_have_no_counterpart():
    """Each omission is still one: the module, the name, the class member
    or the keyword is absent from the port, and every entry names something
    the JAX package has."""
    for (module, what), reason in DELIBERATE.items():
        assert reason, (module, what)
        assert module in JAX_MODULES, f"DELIBERATE names carta1_tpu.{module}, which does not exist"
        if what == "*":
            assert _port_module(module) is None, f"{module}: the port has it now"
            continue
        surface = jax_surface(_jax_path(module))
        if what.endswith("[order]"):                 # a counterpart with another positional contract
            name = what[:-len("[order]")]
            assert name in surface and _counterpart(module, name) is not None, f"{module}.{what}: no such pair"
            continue
        name, _, param = what.partition("(")
        if "." in name:                              # a class member
            cls, member = name.split(".", 1)
            assert member in jax_members(_jax_path(module)).get(cls, {}), \
                f"DELIBERATE names {module}.{name}, which the JAX package does not have"
            port_cls = _counterpart(module, cls)
            assert inspect.isclass(port_cls) and inspect.getattr_static(port_cls, member, None) is None, \
                f"{module}.{name}: the port has it now"
            continue
        assert name in surface, f"DELIBERATE names {module}.{name}, which the JAX package does not have"
        obj = _counterpart(module, name)
        if param:
            param = param.rstrip(")")
            assert param in surface[name][1], f"{module}.{name} takes no {param} in the JAX package"
            assert obj is not None and _accepts(obj, [param]), f"{module}.{name}: the port takes {param} now"
        else:
            assert obj is None, f"{module}.{name}: the port has it now"


def _positional(obj) -> list[str]:
    return [p.name for p in inspect.signature(obj).parameters.values()
            if p.kind in (inspect.Parameter.POSITIONAL_ONLY, inspect.Parameter.POSITIONAL_OR_KEYWORD)]


def _order_faults(module: str) -> dict[str, str]:
    """name -> fault, for each function or class of the JAX module whose
    positional parameters (less the DELIBERATE ones) are no prefix of its
    counterpart's."""
    faults = {}
    for name, (kind, _, pos, _) in jax_surface(_jax_path(module)).items():
        obj = _counterpart(module, name)
        if kind not in ("function", "class") or (module, name) in DELIBERATE or obj is None:
            continue                  # left out, or a missing name, which the keyword case reports
        want = [p for p in pos if (module, f"{name}({p})") not in DELIBERATE]
        got = _positional(obj)
        if got[:len(want)] != want:
            faults[name] = f"{name}: positional {got} does not start with the JAX package's {want}"
    return faults


@pytest.mark.parametrize("module", JAX_MODULES, ids=lambda m: m or "__init__")
def test_port_takes_the_jax_modules_positional_parameters_in_order(module):
    """A positional call written for `carta1_tpu` binds the same parameters in
    the port: the port's own parameters come after the JAX package's."""
    if (module, "*") in DELIBERATE:
        return
    faults = [f for name, f in _order_faults(module).items() if (module, f"{name}[order]") not in DELIBERATE]
    assert not faults, f"carta1_tpu.{module}: " + "; ".join(faults)


def _annotation(ann) -> str | None:
    if ann is inspect.Signature.empty:
        return None
    text = ann if isinstance(ann, str) else inspect.formatannotation(ann)
    return ast.unparse(ast.parse(text, mode="eval"))


def _return_departures(module: str) -> dict[str, tuple[str, str | None]]:
    """name -> (the JAX annotation as the port would spell it, the port's)
    for each function whose return annotations differ."""
    out = {}
    for name, (kind, _, _, ret) in jax_surface(_jax_path(module)).items():
        obj = _counterpart(module, name)
        if kind != "function" or ret is None or (module, name) in DELIBERATE or obj is None:
            continue
        want = _JAX_ARRAY.sub("torch.Tensor", ret)
        if module in NUMPY_AS_TENSOR:
            want = re.sub(r"\bnp\.ndarray\b", "torch.Tensor", want)
        want = ast.unparse(ast.parse(want, mode="eval"))
        got = _annotation(inspect.signature(obj).return_annotation)
        if got != want:
            out[name] = (want, got)
    return out


@pytest.mark.parametrize("module", JAX_MODULES, ids=lambda m: m or "__init__")
def test_port_returns_what_the_jax_module_returns(module):
    """Every return annotation of the JAX module (arrays read as tensors) is
    the counterpart's, unless `RETURNS` records the departure."""
    if (module, "*") in DELIBERATE:
        return
    faults = []
    for name, (want, got) in _return_departures(module).items():
        recorded = RETURNS.get((module, name))
        if recorded is None:
            faults.append(f"{name} returns {got}, the JAX package {want}")
        elif got != recorded[0]:
            faults.append(f"{name} returns {got}, RETURNS records {recorded[0]}")
    assert not faults, f"carta1_tpu.{module}: " + "; ".join(faults)


def test_recorded_departures_are_still_departures():
    """Each `[order]` entry of DELIBERATE, each entry of RETURNS and each
    module of NUMPY_AS_TENSOR names a difference the port still has, so no
    list can go stale."""
    for (module, what), reason in DELIBERATE.items():
        if what.endswith("[order]"):
            assert what[:-len("[order]")] in _order_faults(module), f"{module}.{what}: the order agrees now"
    for (module, name), (_, reason) in RETURNS.items():
        assert reason and name in _return_departures(module), f"{module}.{name}: the return annotation agrees now"
    for module, reason in NUMPY_AS_TENSOR.items():
        returns = [ret for _, _, _, ret in jax_surface(_jax_path(module)).values() if ret]
        assert reason and any("np.ndarray" in r for r in returns), f"{module} returns no NumPy array"


def test_k3_rejects_a_jax_order_call():
    """The TPU kernel's call `window_reduce_pallas(win32, h, j_lo, j_hi)`
    raises against K3's wrapper instead of reading other bits."""
    from carta1_tpu_torch.ops.bitpack_kernels import read_fields

    win32 = torch.zeros((4, 128), dtype=torch.int32)
    h = torch.zeros((4, 52), dtype=torch.int32)
    with pytest.raises(TypeError):
        read_fields(win32, h, 0, 128)
    with pytest.raises(TypeError):
        read_fields(win32, h, 0, 128, 256)                   # with the TPU kernel's block_frames
