"""The port stands alone: importing it never pulls in JAX, Flax, optax, orbax
or the JAX package, and its kernel build has no fallback."""

import ast
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "videomv_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "videomv_tpu")


# the entry points and leaf modules; everything else is imported by these
IMPORTS = (
    "videomv_tpu_torch", "videomv_tpu_torch.inference", "videomv_tpu_torch.ops",
    "videomv_tpu_torch.inference.__main__", "videomv_tpu_torch.training",
    "videomv_tpu_torch.models", "videomv_tpu_torch.utils", "videomv_tpu_torch.config",
    "videomv_tpu_torch.training.__main__", "videomv_tpu_torch.training.engine",
    "videomv_tpu_torch.training.lgm_refine", "videomv_tpu_torch.training.optim",
    "videomv_tpu_torch.models.lpips", "videomv_tpu_torch.data.datasets",
    "videomv_tpu_torch.ops.gs_cameras", "videomv_tpu_torch.utils.device",
    "videomv_tpu_torch.inference.i2v", "videomv_tpu_torch.models.unet_i2v",
    "videomv_tpu_torch.ops.fused_spatial", "videomv_tpu_torch.parallel",
    "videomv_tpu_torch.parallel.train_step", "videomv_tpu_torch.training.hooks",
    "videomv_tpu_torch.data.laion", "videomv_tpu_torch.data.native_loader",
    "videomv_tpu_torch.utils.video_io", "videomv_tpu_torch.utils.seed",
    "videomv_tpu_torch.data.recenter", "videomv_tpu_torch.parallel.mesh",
    "videomv_tpu_torch.parallel.collectives", "videomv_tpu_torch.parallel.infer",
    "videomv_tpu_torch.parallel.tp", "videomv_tpu_torch.parallel.dryrun",
    "videomv_tpu_torch.utils.profiling", "videomv_tpu_torch.models.unet_sv3d",
    "videomv_tpu_torch.diffusion.edm", "videomv_tpu_torch.inference.sv3d",
)


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def _package_modules():
    for root, _, files in os.walk(PKG):
        for fn in files:
            if fn.endswith(".py"):
                rel = os.path.relpath(os.path.join(root, fn), REPO)[:-3].replace(os.sep, ".")
                yield rel[:-len(".__init__")] if rel.endswith(".__init__") else rel


def test_import_leaves_jax_out_of_sys_modules():
    """Importing ``IMPORTS`` loads every module of the package and none of
    the forbidden ones."""
    prog = (
        "import sys\n"
        + "".join(f"import {m}\n" for m in IMPORTS)
        + "bad = sorted(m for m in sys.modules if m in %r or m.split('.')[0] in %r)\n"
        "print(','.join(bad))\n" % (FORBIDDEN, FORBIDDEN)
        + "print(','.join(m for m in %r if m not in sys.modules))\n"
        % (sorted(_package_modules()),))
    r = subprocess.run([sys.executable, "-c", prog], cwd=REPO, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stderr
    bad, never_imported = r.stdout.split("\n")[:2]
    assert bad.strip() == ""
    assert never_imported.strip() == "", "add these modules to IMPORTS"


def test_no_source_file_imports_jax():
    for root, _, files in os.walk(PKG):
        for fn in files:
            if not fn.endswith(".py"):
                continue
            path = os.path.join(root, fn)
            with open(path) as f:
                tree = ast.parse(f.read(), path)
            for node in ast.walk(tree):
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.level == 0:
                    names = [node.module or ""]
                else:
                    continue
                assert not any(_forbidden(n) for n in names), (path, names)


def test_kernel_build_without_nvcc_raises(tmp_path, monkeypatch):
    from videomv_tpu_torch.ops import _build

    monkeypatch.setattr(_build, "_lib", None)
    # an empty build directory, so no cached library can stand in for a build
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(_build, "_DEFAULT_CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    for var in ("CUDA_HOME", "CUDA_PATH"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load_library()
    assert _build._lib is None


def test_every_cuda_source_is_built_and_bound():
    """Each ``csrc/*.cu`` defines the C entry points ``_build`` binds, the
    shared device code sits in headers beside them, and every kernel source
    states which TPU kernel it replaces, or that it replaces none."""
    import glob
    import re

    from videomv_tpu_torch.ops import _build

    srcs = sorted(glob.glob(os.path.join(_build.CSRC_DIR, "*.cu")))
    assert [os.path.basename(s) for s in srcs] == [
        "flash_attention.cu", "flash_attention_bwd.cu", "fused_ffn.cu", "fused_spatial.cu",
        "group_norm.cu", "splat_composite.cu", "splat_composite_bwd.cu"]
    entry = {}
    for path in srcs:
        text = open(path).read()
        for name, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', text):
            entry[name] = len([p for p in params.split(",") if p.strip()])
        assert ("// Replaces: videomv_tpu/ops/" in text
                or "// Replaces no TPU kernel: " in text), path
    # the same names, and as many arguments as the ctypes signature passes
    assert entry == {name: len(sig) for name, sig in _build._SIGNATURES.items()}
    # each header of tile code is included by exactly its users: kernel 1's
    # mma.sync tile step, and the splat composite's culling, shared by its
    # forward and backward through a header, not copies
    for hdr, users in (("attention_tile.cuh", ("flash_attention.cu",)),
                       ("splat_cull.cuh", ("splat_composite.cu", "splat_composite_bwd.cu"))):
        assert os.path.exists(os.path.join(_build.CSRC_DIR, hdr))
        for path in srcs:
            text = open(path).read()
            assert (f'#include "{hdr}"' in text) == (os.path.basename(path) in users), (hdr, path)
    assert sorted(os.path.basename(h) for h in glob.glob(os.path.join(_build.CSRC_DIR, "*.cuh"))) \
        == ["attention_tile.cuh", "hopper_utils.cuh", "mma_utils.cuh", "splat_cull.cuh",
            "wgmma_ops.cuh"]
    # the wgmma kernels of attention, the FFN and the fused block share their
    # Hopper helpers; the splat kernels and the attention backward (mma.sync)
    # use none
    for hdr in ("hopper_utils.cuh", "wgmma_ops.cuh"):
        for u in ("flash_attention.cu", "fused_ffn.cu", "fused_spatial.cu"):
            assert f'#include "{hdr}"' in open(os.path.join(_build.CSRC_DIR, u)).read(), (hdr, u)
        for u in ("flash_attention_bwd.cu", "group_norm.cu", "splat_composite.cu",
                  "splat_composite_bwd.cu"):
            assert f'#include "{hdr}"' not in open(os.path.join(_build.CSRC_DIR, u)).read()
    assert "sm_90a" in " ".join(_build.NVCC_FLAGS)
