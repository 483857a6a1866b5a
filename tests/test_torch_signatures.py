"""The port's public surface against the JAX package's, parameter by
parameter: for every module of `fastlanes_tpu` that has a counterpart in
`fastlanes_tpu_torch`, every public function and every public method of a
public class there exists in the port, and each of its parameters exists in
the port's signature under the same name (a caller that passes it by
keyword reaches the same parameter). A name check alone misses a missing
parameter; this one does not.

What the port leaves out on purpose is listed below, each entry with the
ground rule of ROADMAP.md behind it, and nothing else is: a new entry of the
JAX package, or a parameter the port drops, fails here until it is ported
or a ground rule covers it."""

import importlib
import importlib.util
import inspect
import pkgutil

import pytest

import fastlanes_tpu
import fastlanes_tpu_torch

#: JAX modules without a counterpart module in the port -> the ground rule
UNPAIRED_MODULES = {
    "limbs": "the u64 limb engine is no internal form of the port (a u64 is one native tensor)",
    "ops.swar": "never routed; its docstring records a negative result",
    "kernels.pallas_codecs": "the Pallas kernels; the port's are kernels/cuda_codecs.py",
    "kernels.routing": "one path per op: no routing between Pallas, XLA and the limb engine",
}

_LIMBS = "the u64 limb engine is no internal form of the port"
_XLA_ORIG = "the XLA formulations of ops/orig.py: the port needs only their semantics"

#: (module, function) of the JAX package the port has no counterpart of -> the ground rule
MISSING_FUNCTIONS = {
    ("alp", "eng_shl_dyn"): _LIMBS,
    ("ops._engine", "is_limb"): _LIMBS,
    ("ops._engine", "jnp_dtype"): "jnp dtypes: the port's engine speaks torch dtypes",
    ("ops.bitpack", "unpack_planes"): _LIMBS,
    ("ops.dispatch", "eng_dtype"): _LIMBS,
    ("transforms", "zigzag_decode_limb"): _LIMBS,
    ("transforms", "zigzag_encode_limb"): _LIMBS,
    ("ops.orig", "unpack_orig"): _XLA_ORIG,
    ("ops.orig", "undelta_pack_orig"): _XLA_ORIG,
    ("ops.orig", "unzdelta_pack_orig"): _XLA_ORIG,
    ("utils.testing", "to_jax_form"): "conversion to JAX arrays: the port imports no jax",
    ("utils.testing", "from_jax_form"): "conversion from JAX arrays: the port imports no jax",
}

_ROUTING = "use_kernels: the port has one path per op (the kernel on CUDA, the plain version on the CPU)"
_PLANES = "planes: a u64 column is one native tensor in the port, not two uint32 limb planes"
_ENGINE = "an engine helper's JAX shape or limb argument: the port's helpers take torch tensors"

#: a parameter name the port leaves out of every function -> the ground rule
MISSING_EVERYWHERE = {"use_kernels": _ROUTING, "planes": _PLANES}

#: (module, function, parameter) the port leaves out -> the ground rule
MISSING_PARAMETERS = {
    ("parallel.mesh", "make_mesh", "devices"):
        "make_mesh(devices=): the port's mesh is the ranks of a process group, one device a "
        "process, chosen by device= and setup_distributed",
    ("ops._engine", "const", "shape"): _ENGINE,
    ("ops._engine", "from_vec", "like"): _ENGINE,
    ("ops._engine", "promote_shape", "dtype"): _ENGINE,
    ("ops._engine", "squeeze_shape", "dtype"): _ENGINE,
    ("ops.bitpack", "pack_words", "batch_shape"): _ENGINE,
    ("ops.bitpack", "unpack_row_stream", "get_word"): _ENGINE,
}


def _modules(pkg) -> dict:
    """relative name ("" for the package) -> module, Python sources only
    (not a built library, not the command-line entry `__main__`)."""
    out = {"": pkg}
    for info in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
        if info.name.endswith(".__main__"):
            continue
        origin = importlib.util.find_spec(info.name).origin or ""
        if origin.endswith(".py"):
            out[info.name[len(pkg.__name__) + 1:]] = importlib.import_module(info.name)
    return out


JAX_MODULES = _modules(fastlanes_tpu)
PORT_MODULES = _modules(fastlanes_tpu_torch)
PAIRS = sorted(set(JAX_MODULES) & set(PORT_MODULES))


def _public(mod) -> dict:
    """name -> function of every public function defined in `mod`, and
    "Class.method" -> function of every public method (and __init__) that a
    public class defined in `mod` defines."""
    out = {}
    for name, obj in vars(mod).items():
        if name.startswith("_") or getattr(obj, "__module__", None) != mod.__name__:
            continue
        if inspect.isfunction(obj):
            out[name] = obj
        elif inspect.isclass(obj):
            for meth, fn in vars(obj).items():
                if (meth == "__init__" or not meth.startswith("_")) and inspect.isfunction(fn):
                    out[f"{name}.{meth}"] = fn
    return out


def _counterpart(mod, qualname: str):
    """The port's function of that name in `mod` (a method may be inherited)."""
    obj = mod
    for part in qualname.split("."):
        obj = getattr(obj, part, None)
        if obj is None:
            return None
    return obj


def test_modules_without_a_counterpart_are_the_ground_rules():
    assert sorted(set(JAX_MODULES) - set(PORT_MODULES)) == sorted(UNPAIRED_MODULES)


@pytest.mark.parametrize("module", PAIRS, ids=lambda m: m or "package")
def test_every_function_of_the_reference_exists_in_the_port(module):
    missing = [name for name in _public(JAX_MODULES[module])
               if _counterpart(PORT_MODULES[module], name) is None
               and (module, name) not in MISSING_FUNCTIONS]
    assert missing == [], f"{module}: the port lacks {missing}"


@pytest.mark.parametrize("module", PAIRS, ids=lambda m: m or "package")
def test_every_parameter_of_the_reference_exists_in_the_port(module):
    """Each parameter of a JAX function is a parameter of the port's, by
    name, unless a ground rule leaves it out."""
    missing = []
    for name, fn in _public(JAX_MODULES[module]).items():
        port = _counterpart(PORT_MODULES[module], name)
        if port is None:
            continue
        have = inspect.signature(port).parameters
        missing += [f"{name}({p}=)" for p in inspect.signature(fn).parameters
                    if p not in have and p not in MISSING_EVERYWHERE
                    and (module, name, p) not in MISSING_PARAMETERS]
    assert missing == [], f"{module}: the port lacks {missing}"


def test_the_allow_lists_name_only_what_the_reference_has():
    """Every entry of the allow-lists names a module, function or parameter
    that the JAX package has and the port lacks: none is stale."""
    assert set(UNPAIRED_MODULES) <= set(JAX_MODULES)
    for module, name in MISSING_FUNCTIONS:
        assert name in _public(JAX_MODULES[module])
        assert _counterpart(PORT_MODULES[module], name) is None, (module, name)
    for module, name, p in MISSING_PARAMETERS:
        assert p in inspect.signature(_public(JAX_MODULES[module])[name]).parameters
        assert p not in inspect.signature(
            _counterpart(PORT_MODULES[module], name)).parameters, (module, name, p)
