"""The port's public surface against the JAX package's, read with ``ast``.

Neither package is imported.  For every module of ``crimac_unet_tpu/``
with a counterpart path in ``crimac_unet_tpu_torch/`` (the same relative
path, or the one ``MODULE_MAP`` names):

(a) every public top-level name of the JAX module (a ``def``, a
    ``class`` or an assignment; names bound by imports do not count) and
    every public method of its classes (private classes included;
    methods inherited from a base class in the same module count) has a
    counterpart of the same name in the port's module, where the port's
    re-exports by import count;
(b) for every public function and method in both (and every
    ``__init__``), each JAX positional parameter sits at the same index
    in the port, under its own name or its ``RENAMES`` name; each JAX
    default equals the port's (as source text); each JAX keyword-only
    parameter is accepted by name; the port's positional parameters past
    the JAX ones, and its keyword-only ones the JAX function lacks, have
    defaults, so a call written for the JAX package binds in the port as
    it binds there.  Private functions are implementation, not surface.

Anything else fails unless ``DIFFERENCES`` lists it: each entry names the
port's counterpart (checked to exist) and one line of reason, and an
entry that no longer matches a difference fails too, so the table stays
exact.
"""

from __future__ import annotations

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
JAX = ROOT / "crimac_unet_tpu"
PORT = ROOT / "crimac_unet_tpu_torch"

# JAX module -> its counterpart where the paths differ
MODULE_MAP = {
    "models/torch_import.py": "models/weights.py",
    "ops/pallas_gather.py": "ops/gather_db.py",
    "ops/pallas_pool.py": "ops/pool.py",
    "ops/pallas_morphology.py": "ops/closing.py",
}

# JAX parameter name -> the port's name for it (the JAX name is accepted
# too: the port keeps ``rng`` where it is a numpy RandomState)
RENAMES = {"key": "gen", "rng": "gen", "variables": "state_dict",
           "platforms": "device", "sharding": "device"}

# "<JAX module>::<name or Class.method>" ->
#     ("<port module>::<counterpart>", reason)
DIFFERENCES = {
    "models/unet.py::ConvBNRelu": (
        "models/unet.py::DownConv",
        "flax submodule; torch idiom keeps conv + BatchNorm + ReLU inside "
        "DownConv and UpConv"),
    "models/unet.py::Transpose2x2": (
        "models/unet.py::UpConv",
        "flax submodule; UpConv holds its nn.ConvTranspose2d"),
    "models/unet.py::conv_kernel_init": (
        "models/unet.py::init_train_",
        "flax initializer of torch's default conv init, which init_train_ "
        "draws"),
    "models/fold_bn.py::fold_batchnorm": (
        "models/fold_bn.py::fold_state_dict",
        "folds a flax variables tree; the port folds a state dict"),
    "models/fold_bn.py::fold_variables": (
        "models/fold_bn.py::fold_state_dict",
        "folds a flax variables tree; the port folds a state dict"),
    "utils/profiling.py::annotate": (
        "utils/general.py::PhaseTimer",
        "a named region in traces: the timer's phases, which device_trace "
        "writes into its trace as spans"),
    "utils/flops.py::compiled_flops": (
        "utils/flops.py::counted_flops",
        "reads XLA's cost analysis, which the card has no counterpart of; "
        "FlopCounterMode counts instead"),
    "pipeline/runner.py::GriddedRunner.variables": (
        "pipeline/runner.py::GriddedRunner.__init__",
        "the flax variables tree; the runner takes a state_dict and holds "
        "the (folded) torch module"),
    "parallel/mesh.py::replicated": (
        "parallel/mesh.py::replicate_",
        "a jax.sharding spec; torch.distributed broadcasts in place"),
    "parallel/mesh.py::batch_sharding": (
        "parallel/mesh.py::checked_shard",
        "a jax.sharding spec; each rank takes its rows"),
    "parallel/mesh.py::shard_batch": (
        "parallel/mesh.py::checked_shard",
        "device_put under a jax sharding; each rank takes its rows"),
    "parallel/mesh.py::checked_put": (
        "parallel/mesh.py::checked_shard",
        "device_put under a jax sharding; each rank takes its rows"),
    "parallel/mesh.py::replicate_tree": (
        "parallel/mesh.py::replicate_",
        "device_put of a pytree; torch.distributed broadcasts in place"),
    "parallel/mesh.py::init_distributed": (
        "parallel/mesh.py::init_distributed",
        "takes torch.distributed's init_method, world_size and rank"),
    "parallel/multihost_check.py::run_two_process_check": (
        "parallel/multihost_check.py::run_two_process_check",
        "default timeout 300 s: two gloo ranks need no XLA compile"),
    "ops/label_ops.py::USE_PALLAS_MORPHOLOGY": (
        "ops/closing.py::binary_closing",
        "K4 launches on every CUDA tensor; there is no switch"),
    "ops/label_ops.py::use_pallas_morphology": (
        "ops/closing.py::binary_closing",
        "K4 launches on every CUDA tensor; there is no switch"),
    "ops/pallas_gather.py::gather_db_pallas": (
        "ops/gather_db.py::gather_db",
        "K1's entry: the CUDA kernel's operator, not a Pallas call"),
    "ops/pallas_morphology.py::binary_closing_pallas": (
        "ops/closing.py::binary_closing",
        "K4's entry: the CUDA kernel's operator, not a Pallas call"),
    "ops/pallas_pool.py::supported": (
        "ops/pool.py::maxpool2x2",
        "Pallas' shape gate; K2 and K3 take every CUDA shape"),
    "ops/pallas_pool.py::resolve_flag": (
        "ops/pool.py::relu_pool_skip",
        "Pallas' platform gate; K2 and K3 launch on every CUDA tensor"),
    "ops/pallas_pool.py::maxpool2x2": (
        "ops/pool.py::maxpool2x2",
        "keyword interpret: a CUDA kernel has no interpret mode (a CPU "
        "tensor takes the plain version)"),
    "ops/pallas_pool.py::relu_pool_skip": (
        "ops/pool.py::relu_pool_skip",
        "keyword interpret: a CUDA kernel has no interpret mode (a CPU "
        "tensor takes the plain version)"),
    "ops/augment.py::add_noise": (
        "ops/augment.py::add_noise",
        "takes its random draws (split from the key in JAX) from the "
        "caller, drawn for the global batch by augment_train"),
    "ops/augment.py::flip_x_axis": (
        "ops/augment.py::flip_x_axis",
        "takes its random draw (split from the key in JAX) from the "
        "caller, drawn for the global batch by augment_train"),
    "pipeline/engine.py::make_optimizer": (
        "pipeline/engine.py::make_optimizer",
        "a torch optimizer is built over the model's parameters"),
    "pipeline/engine.py::make_train_step": (
        "pipeline/engine.py::make_train_step",
        "the step takes the model through its TrainState"),
    "pipeline/engine.py::make_train_step_pooled": (
        "pipeline/engine.py::make_train_step_pooled",
        "the step takes the model through its TrainState"),
    "pipeline/engine.py::make_eval_step": (
        "pipeline/engine.py::make_eval_step",
        "the step takes the model through its TrainState"),
    "pipeline/engine.py::make_eval_step_pooled": (
        "pipeline/engine.py::make_eval_step_pooled",
        "the step takes the model through its TrainState"),
}


def _statements(body):
    """Top-level statements, looking into ``if`` / ``try`` blocks."""
    for s in body:
        if isinstance(s, (ast.If, ast.Try)):
            yield from _statements(s.body)
            yield from _statements(s.orelse)
            for h in getattr(s, "handlers", ()):
                yield from _statements(h.body)
            yield from _statements(getattr(s, "finalbody", ()))
        else:
            yield s


def _targets(s):
    targets = s.targets if isinstance(s, ast.Assign) else [s.target]
    for t in targets:
        for n in ast.walk(t):
            if isinstance(n, ast.Name):
                yield n.id


class Surface:
    """Top-level names, functions and class methods of one module."""

    def __init__(self, source: str, imports_count: bool):
        self.names, self.functions, classes = set(), {}, {}
        for s in _statements(ast.parse(source).body):
            if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.names.add(s.name)
                self.functions[s.name] = s
            elif isinstance(s, ast.ClassDef):
                self.names.add(s.name)
                classes[s.name] = s
            elif isinstance(s, (ast.Assign, ast.AnnAssign)):
                self.names.update(_targets(s))
            elif imports_count and isinstance(s, (ast.Import,
                                                  ast.ImportFrom)):
                self.names.update((a.asname or a.name).split(".")[0]
                                  for a in s.names)
        self.methods = {name: self._methods(c, classes)
                        for name, c in classes.items()}

    def _methods(self, cls, classes, seen=()):
        out = {}
        for base in cls.bases:
            if isinstance(base, ast.Name) and base.id in classes \
                    and base.id not in seen:
                out.update(self._methods(classes[base.id], classes,
                                         seen + (cls.name,)))
        for s in _statements(cls.body):
            if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef)):
                out[s.name] = s
        return out

    def has(self, qual: str) -> bool:
        cls, _, meth = qual.partition(".")
        if not meth:
            return cls in self.names
        return meth in self.methods.get(cls, {})


def _signature(f):
    a = f.args
    pos = a.posonlyargs + a.args
    defaults = [None] * (len(pos) - len(a.defaults)) + \
        [ast.unparse(d) for d in a.defaults]
    kwonly = {k.arg: None if d is None else ast.unparse(d)
              for k, d in zip(a.kwonlyargs, a.kw_defaults)}
    return ([p.arg for p in pos], defaults, kwonly,
            a.vararg is not None, a.kwarg is not None)


def signature_findings(jax_fn, port_fn) -> list:
    """What a call written for ``jax_fn`` would bind differently in
    ``port_fn`` (empty when every JAX call binds alike)."""
    jpos, jdef, jkw, jvar, jvkw = _signature(jax_fn)
    ppos, pdef, pkw, pvar, pvkw = _signature(port_fn)
    out = []
    for i, (name, default) in enumerate(zip(jpos, jdef)):
        if i >= len(ppos) or ppos[i] not in (name, RENAMES.get(name)):
            got = ppos[i] if i < len(ppos) else "nothing"
            out.append(f"positional {i} is {name!r} in JAX, {got!r} in "
                       f"the port")
        elif default is not None and default != pdef[i]:
            out.append(f"{name}={default} in JAX, {pdef[i]} in the port")
    for i in range(len(jpos), len(ppos)):
        if pdef[i] is None:
            out.append(f"the port's extra positional {ppos[i]!r} has no "
                       f"default")
    jnames = {RENAMES.get(n, n) for n in jpos + list(jkw)} | \
        set(jpos) | set(jkw)
    for name, default in pkw.items():
        if default is None and name not in jnames:
            out.append(f"the port's extra keyword {name!r} has no default")
    for name, default in jkw.items():
        want = {name, RENAMES.get(name)}
        hit = [k for k in want if k in pkw] or \
            [k for k in want if k in ppos]
        if not hit:
            if not pvkw:
                out.append(f"keyword {name!r} is not accepted")
            continue
        got = pkw[hit[0]] if hit[0] in pkw else pdef[ppos.index(hit[0])]
        if default is not None and default != got:
            out.append(f"{name}={default} in JAX, {got} in the port")
    if jvar and not pvar:
        out.append("*args is not accepted")
    if jvkw and not pvkw:
        out.append("**kwargs is not accepted")
    return out


def module_findings(jax_src: str, port_src: str, rel: str) -> dict:
    """``{"<rel>::<qual>": [finding, ...]}`` for one module pair."""
    j, p = Surface(jax_src, False), Surface(port_src, True)
    out: dict = {}

    def add(qual, msg):
        out.setdefault(f"{rel}::{qual}", []).append(msg)

    for name in sorted(j.names):
        if not name.startswith("_") and name not in p.names:
            add(name, "no counterpart")
    for name, fn in j.functions.items():
        if not name.startswith("_") and name in p.functions:
            for msg in signature_findings(fn, p.functions[name]):
                add(name, msg)
    for cls, methods in j.methods.items():
        if cls not in p.methods:
            continue    # a missing public class is reported above
        for name, fn in methods.items():
            if name.startswith("_") and name != "__init__":
                continue
            qual = f"{cls}.{name}"
            port_fn = p.methods[cls].get(name)
            if port_fn is None:
                if name != "__init__":
                    add(qual, "no counterpart")
                continue
            for msg in signature_findings(fn, port_fn):
                add(qual, msg)
    return out


def _read(path: Path) -> str:
    return path.read_text(encoding="utf-8")


JAX_MODULES = sorted(str(p.relative_to(JAX)) for p in JAX.rglob("*.py"))


def _port_path(rel: str) -> Path:
    return PORT / MODULE_MAP.get(rel, rel)


def _findings(rel: str) -> dict:
    return module_findings(_read(JAX / rel), _read(_port_path(rel)), rel)


@pytest.mark.parametrize("rel", JAX_MODULES)
def test_module_surface_matches(rel):
    """Names and call signatures of one JAX module in its counterpart."""
    assert _port_path(rel).is_file(), f"{rel} has no counterpart module"
    unexplained = {k: v for k, v in _findings(rel).items()
                   if k not in DIFFERENCES}
    assert not unexplained, "\n".join(
        f"{k}: {'; '.join(v)}" for k, v in sorted(unexplained.items()))


def test_differences_table_is_exact():
    """Every entry still matches a difference, and its counterpart exists
    in the port."""
    found = {}
    for rel in JAX_MODULES:
        found.update(_findings(rel))
    stale = sorted(set(DIFFERENCES) - set(found))
    assert not stale, f"entries with no difference left: {stale}"
    for key, (counterpart, reason) in DIFFERENCES.items():
        assert reason and len(reason.splitlines()) == 1, key
        module, _, qual = counterpart.partition("::")
        surface = Surface(_read(PORT / module), True)
        assert surface.has(qual), f"{key}: no {counterpart} in the port"


# the port's DeviceSamplePool.__init__ as it was before the device
# parameter moved after the JAX ones (a JAX-style call then passed the
# metadata spec as the device)
_JAX_POOL = """
class DeviceSamplePool:
    def __init__(self, readers, frequencies, window, meta_channels=None):
        pass
"""


@pytest.mark.parametrize("port_init, bad", [
    ("(self, readers, frequencies, window, device, meta_channels=None)",
     True),
    ("(self, readers, frequencies, window, meta_channels=None, "
     "device='cuda')", False),
    ("(self, readers, frequencies, window, meta_channels=None, *, "
     "device)", True),
    ("(self, readers, frequencies, window, meta_channels={})", True),
    ("(self, readers, frequencies, window, **kw)", True),
])
def test_checker_catches_a_moved_parameter(port_init, bad):
    """The checker itself: a reordered, defaultless or re-defaulted
    parameter is a finding; the repaired order is not."""
    port = _JAX_POOL.replace(
        "(self, readers, frequencies, window, meta_channels=None)",
        port_init)
    got = module_findings(_JAX_POOL, port, "data/device_pool.py")
    assert bool(got) == bad, got


def test_checker_reads_names_not_imports():
    """A JAX name bound by an import is not required; a port re-export by
    import counts as the counterpart; a missing method is a finding."""
    jax_src = ("from .morphology import DISC_7X7\n"
               "X = 1\n"
               "class A:\n    def f(self):\n        pass\n")
    assert module_findings(jax_src, "from .m import X\nclass A:\n"
                           "    def f(self):\n        pass\n", "m") == {}
    got = module_findings(jax_src, "X = 2\nclass A:\n    pass\n", "m")
    assert got == {"m::A.f": ["no counterpart"]}
