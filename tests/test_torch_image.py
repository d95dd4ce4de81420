"""The port's production image, ``Dockerfile.torch``, read as a file.

No machine of the project's checks builds the image (a build pulls its
base image); ``chip_smoke.py`` phase 23 runs its file set, build step
and command on the card without docker.  Here the file is held to its
contract: the port alone, none of the JAX stack, a CUDA devel base whose
nvcc builds the kernels at image build, the reference's mount points
and the port's docker entry, and every third-party module that entry
imports installed by the file or brought by what it installs.
"""

import ast
import json
import re
import shlex
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
DOCKERFILE = REPO / "Dockerfile.torch"
ENTRY = "crimac_unet_tpu_torch.pipeline.dockerscript"
JAX_STACK = ("jax", "jaxlib", "flax", "optax", "ml_dtypes")
# distribution name -> import name, where they differ
IMPORT_NAMES = {"pyyaml": "yaml"}


def _instructions():
    """(instruction, argument) pairs, continuation lines joined."""
    text = DOCKERFILE.read_text().replace("\\\n", " ")
    out = []
    for line in text.splitlines():
        line = line.strip()
        if line and not line.startswith("#"):
            word, _, rest = line.partition(" ")
            out.append((word.upper(), rest.strip()))
    return out


def _runs():
    return [arg for word, arg in _instructions() if word == "RUN"]


def _pip_installed():
    """Import names of what the file's ``pip install`` commands install."""
    names = set()
    for run in _runs():
        for cmd in run.split("&&"):
            argv = shlex.split(cmd)
            if argv[:2] != ["pip", "install"]:
                continue
            skip = False
            for a in argv[2:]:
                if skip:
                    skip = False
                elif a in ("--index-url", "--extra-index-url", "-i"):
                    skip = True
                elif not a.startswith("-"):
                    dist = re.split(r"[<>=!~\[; ]", a)[0].lower()
                    names.add(IMPORT_NAMES.get(dist, dist))
    return names


def test_copies_the_port_alone():
    copies = [arg.split() for word, arg in _instructions()
              if word in ("COPY", "ADD")]
    assert copies == [["crimac_unet_tpu_torch",
                       "/app/crimac_unet_tpu_torch"]]
    assert ("WORKDIR", "/app") in _instructions()


@pytest.mark.parametrize("name", JAX_STACK + ("crimac_unet_tpu",))
def test_installs_nothing_of_the_jax_stack(name):
    """No install command names ``name`` (``jax[cuda12]``, ``flax==...``,
    the project's own ``crimac-unet-tpu``) or installs the project
    (``pip install .``, whose dependencies are jax and flax)."""
    n = 0
    for run in _runs():
        for cmd in run.split("&&"):
            if "install" not in cmd:
                continue
            n += 1
            argv = shlex.split(cmd)
            assert "." not in argv and "-e" not in argv, cmd
            pkgs = {re.split(r"[<>=!~\[]", a)[0].lower().replace("-", "_")
                    for a in argv if not a.startswith("-")}
            assert name not in pkgs, cmd
    assert n >= 3          # apt, torch, the rest


def test_base_is_a_cuda_devel_image():
    froms = [arg for word, arg in _instructions() if word == "FROM"]
    assert len(froms) == 1
    assert re.fullmatch(r"nvidia/cuda:12\.\d+(\.\d+)?-(cudnn-)?devel-\S+",
                        froms[0]), froms


def test_installs_the_codec_toolchain():
    apt = " ".join(r for r in _runs() if "apt-get install" in r)
    for pkg in ("g++", "libblosc1", "libblosc-dev"):
        assert re.search(rf"(^|\s){re.escape(pkg)}(\s|$)", apt), pkg


def test_build_steps_build_the_kernels_and_the_codec():
    """The build steps are ``chip_smoke.py`` phase 23's: the kernel
    library (``cuda_lib.build``, which imports without nvcc) and the
    native codec, each as ``python -c``."""
    sys.path.insert(0, str(REPO))
    import chip_smoke
    steps = chip_smoke.dockerfile_steps(DOCKERFILE)
    assert [s for s in steps if "cuda_lib.build()" in s] == [
        "from crimac_unet_tpu_torch.ops import cuda_lib; "
        "print(cuda_lib.build())"]
    assert any("blosc_codec" in s and "_load_chunkio()" in s for s in steps)
    from crimac_unet_tpu_torch.data import blosc_codec
    from crimac_unet_tpu_torch.ops import cuda_lib
    assert callable(cuda_lib.build) and callable(blosc_codec._load_chunkio)
    # both land in <package>/../.kernel_build, /app/.kernel_build in the
    # image
    pkg = Path(cuda_lib.__file__).resolve().parent.parent
    assert cuda_lib.BUILD_DIR == blosc_codec.BUILD_DIR \
        == pkg.parent / ".kernel_build"


def test_contract_mount_points_and_command():
    ins = _instructions()
    vols = [json.loads(arg) for word, arg in ins if word == "VOLUME"]
    assert vols == [["/model", "/datain", "/configs", "/dataout"]]
    cmds = [json.loads(arg) for word, arg in ins if word == "CMD"]
    assert cmds == [["python", "-m", ENTRY]]


# the entry imported in a subprocess from a directory that holds the
# port alone: the top-level modules it adds to sys.modules, and for each
# the file whose import statement first asked for it
_CLOSURE = r"""
import sys
before = set(sys.modules)      # the interpreter's start-up (site, .pth)
import importlib.abc, json, traceback
first = {}

class Spy(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if "." not in name and name not in first:
            for f in reversed(traceback.extract_stack()[:-1]):
                if "importlib" not in f.filename \
                        and not f.filename.startswith("<"):
                    first[name] = f.filename
                    break
        return None

sys.meta_path.insert(0, Spy())
import %s
mods = list(sys.modules.items())
files = {n: getattr(m, "__file__", None) for n, m in mods
         if "." not in n and n not in before}
port = sorted(m.__file__ for n, m in mods
              if n.split(".")[0] == "crimac_unet_tpu_torch")
print(json.dumps({"first": first, "files": files, "port": port,
                  "stdlib": sorted(sys.stdlib_module_names)}))
"""


@pytest.fixture(scope="module")
def closure(tmp_path_factory):
    app = tmp_path_factory.mktemp("app")
    shutil.copytree(REPO / "crimac_unet_tpu_torch",
                    app / "crimac_unet_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run(
        [sys.executable, "-c", _CLOSURE % ENTRY], cwd=app,
        env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(app),
             "HOME": str(app)},
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return app, json.loads(proc.stdout.strip().splitlines()[-1])


def _package_dirs(files, names):
    return {n: Path(files[n]).parent for n in names
            if files.get(n) and Path(files[n]).name == "__init__.py"}


def test_entry_imports_from_the_port_alone(closure):
    app, res = closure
    port = Path(res["files"]["crimac_unet_tpu_torch"]).parent
    assert port == app / "crimac_unet_tpu_torch"
    assert not set(res["files"]) & set(JAX_STACK + ("crimac_unet_tpu",))


def test_every_third_party_import_is_installed(closure):
    """Each third-party top-level module the entry loads is installed by
    the file (torch, numpy, scipy, pyyaml), lies inside one of those
    packages (compiled extensions), or was first imported by one of
    them or by the standard library (their own dependencies, required or
    optional); the port's own module-level imports are installed by the
    file."""
    app, res = closure
    installed = _pip_installed()
    assert {"torch", "numpy", "scipy", "yaml"} <= installed
    files, first = res["files"], res["first"]
    stdlib = set(res["stdlib"])
    third = sorted(n for n in files if n not in stdlib and n not in (
        "__main__", "__mp_main__", "crimac_unet_tpu_torch"))
    homes = _package_dirs(files, installed & set(files))
    stdlib_dir = Path(shutil.__file__).parent
    port = app / "crimac_unet_tpu_torch"

    def inside(path, dirs):
        return path is not None and any(
            Path(path).resolve().is_relative_to(d) for d in dirs)
    for name in third:
        if name in installed:
            continue
        own = files.get(name)
        by = first.get(name)
        ok = (inside(own, homes.values())
              or (own is None and by is None)    # made by an extension
              or (inside(by, list(homes.values()) + [stdlib_dir])
                  and not inside(by, [port])))
        assert ok, (name, own, by)

    # the port's own module-level imports, in every port module loaded
    needs = set()
    for path in res["port"]:
        tree = ast.parse(Path(path).read_text())
        for node in tree.body:
            if isinstance(node, ast.Import):
                needs |= {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                needs.add(node.module.split(".")[0])
    needs -= stdlib | {"__future__", "crimac_unet_tpu_torch"}
    assert needs and needs <= installed, needs - installed
    # the docker entry reads CONFIG through yaml, imported at its call
    assert "yaml" in installed
