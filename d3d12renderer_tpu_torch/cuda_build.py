"""Build and bind the port's native code, at first use, from `csrc/`.

* The CUDA kernels: every `csrc/*.cu` compiled for `sm_90a` by its own
  nvcc process, all started together, then linked into one shared library
  with a plain C interface, `build/torch_kernels/<hash>/`, loaded with
  ctypes (`load_library`).  The hash covers the flags and every
  `csrc/*.cu` and `csrc/*.cuh`, so an edit to a shared header rebuilds.
  nvcc's output, ptxas register / stack / spill counts of every kernel
  included, is kept in `build.log` beside the library.
* The host library: the BVH builder (`csrc/bvh_build.cpp`) and the mesh
  import helpers (`csrc/mesh_ops.cpp`: weld, normals, OBJ scan), built
  with g++ into `build/torch_native/<hash>/` (`load_host_library`).

Nothing is built when a module is imported.  A failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional, Sequence

import torch

_PACKAGE_DIR = Path(__file__).resolve().parent
CSRC_DIR = _PACKAGE_DIR / "csrc"
BUILD_DIR = _PACKAGE_DIR.parent / "build" / "torch_kernels"
HOST_BUILD_DIR = _PACKAGE_DIR.parent / "build" / "torch_native"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-I", "csrc")
LINK_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-shared")
LIBRARY_NAME = "libd3d12_torch_kernels.so"
HOST_FLAGS = ("-std=c++17", "-O3", "-shared", "-fPIC")
HOST_SOURCES = ("bvh_build.cpp", "mesh_ops.cpp")
HOST_LIBRARY_NAME = "libd3d12_torch_host.so"


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME or put nvcc on PATH)")
    return found


def _gxx() -> str:
    found = shutil.which("g++")
    if found is None:
        raise RuntimeError("g++ not found: the host library "
                           f"(csrc/{', '.join(HOST_SOURCES)}) needs a C++ "
                           "compiler")
    return found


def _hashed_dir(root: Path, flags: Sequence[str], sources) -> Path:
    digest = hashlib.sha256(" ".join(flags).encode())
    for src in sources:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return root / digest.hexdigest()[:16]


def build_dir() -> Path:
    """`BUILD_DIR/<hash>` of the flags and every csrc/*.cu and csrc/*.cuh."""
    return _hashed_dir(BUILD_DIR, NVCC_FLAGS + LINK_FLAGS,
                       sorted(CSRC_DIR.glob("*.cu"))
                       + sorted(CSRC_DIR.glob("*.cuh")))


def _compile(cmd, out_dir: Path, name: str, what: str, log: str = "") -> Path:
    """Run `cmd + ["-o", tmp]` unless `out_dir/name` exists; `log` and the
    compiler's output go to `out_dir/build.log`; the library appears
    atomically."""
    lib = out_dir / name
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"{name}.{os.getpid()}.tmp"
    proc = subprocess.run([*cmd, "-o", str(tmp)], capture_output=True,
                          text=True, cwd=CSRC_DIR.parent)
    (out_dir / "build.log").write_text(log + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"{what} failed (rc={proc.returncode}):\n"
                           f"{proc.stderr[-4000:]}")
    os.replace(tmp, lib)
    return lib


def build_library() -> Path:
    """Compile each csrc/*.cu in its own nvcc process, all at once, and
    link the objects into one library, unless a build of the same sources
    and flags exists."""
    out_dir = build_dir()
    if (out_dir / LIBRARY_NAME).exists():
        return out_dir / LIBRARY_NAME
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    jobs = []
    for src in sorted(CSRC_DIR.glob("*.cu")):
        obj = out_dir / f"{src.stem}.{os.getpid()}.o"
        jobs.append((src, obj, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            cwd=CSRC_DIR.parent)))
    log, failed = "", []
    for src, _, proc in jobs:
        out = proc.communicate()[0]
        log += f"== {src.name}\n{out}"
        if proc.returncode != 0:
            failed.append(f"{src.name} (rc={proc.returncode}):\n{out[-2000:]}")
    if failed:
        (out_dir / "build.log").write_text(log)
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    lib = _compile([nvcc, *LINK_FLAGS, *(str(obj) for _, obj, _ in jobs)],
                   out_dir, LIBRARY_NAME, "nvcc link", log)
    for _, obj, _ in jobs:
        obj.unlink()
    return lib


def build_host_library() -> Path:
    """Compile the HOST_SOURCES with g++ unless a build exists."""
    srcs = [CSRC_DIR / name for name in HOST_SOURCES]
    out_dir = _hashed_dir(HOST_BUILD_DIR, HOST_FLAGS, srcs)
    return _compile([_gxx(), *HOST_FLAGS, *(str(s) for s in srcs)], out_dir,
                    HOST_LIBRARY_NAME, "g++")


_library: Optional[ctypes.CDLL] = None
_host_library: Optional[ctypes.CDLL] = None


def load_library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel library once per process;
    binds the entry points of every kernel."""
    global _library
    if _library is None:
        lib = ctypes.CDLL(str(build_library()))
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        # The colored solver (physics/solver_cuda.py).
        lib.colored_solver_launch.argtypes = [
            ptr, ptr, ptr, ptr, ptr, i32,     # vel/omega in, out; prep, stride
            ptr, i32, ptr, ptr, ptr, ptr,     # tables, count, colors, a, b, dyn
            i32, i32, i32, i32,               # slots, impulses, B, iterations
            i32, i32, ptr]                    # team width, device, stream
        lib.solver_shared_limit.argtypes = [i32]
        lib.colored_solver_blocks_per_sm.argtypes = [i32, i32]
        # The fused whole-substep kernel (physics/substep_cuda.py): a
        # FusedArgs struct by address, the team width, the device and the
        # stream.
        lib.fused_substep_launch.argtypes = [ptr, i32, i32, ptr]
        lib.fused_substep_blocks_per_sm.argtypes = [i32, i32]
        for name in ("colored_solver_launch", "solver_shared_limit",
                     "colored_solver_blocks_per_sm", "fused_substep_launch",
                     "fused_substep_blocks_per_sm", "fused_substep_args_size"):
            getattr(lib, name).restype = i32
        # The two ray kernels (ops/ray_trace.py): a RayArgs struct by
        # address, the device and the stream.
        for name in ("ray_closest_hit_bvh_launch",
                     "ray_closest_hit_brute_launch"):
            getattr(lib, name).argtypes = [ptr, i32, ptr]
            getattr(lib, name).restype = i32
        lib.ray_args_size.restype = i32
        lib.ray_max_stack.restype = i32
        # The path tracer's two shading kernels (ops/pt_shade.py): a
        # ShadeArgs struct by address, the device and the stream.
        for name in ("pt_shade_hit_launch", "pt_shade_next_launch"):
            getattr(lib, name).argtypes = [ptr, i32, ptr]
            getattr(lib, name).restype = i32
        lib.pt_shade_args_size.restype = i32
        # The raster kernel (ops/raster.py) and the image kernels
        # (ops/image.py): an argument struct by address, device, stream.
        for name in ("raster_launch", "raster_groups_launch",
                     "gaussian_blur_launch", "tonemap_launch"):
            getattr(lib, name).argtypes = [ptr, i32, ptr]
            getattr(lib, name).restype = i32
        for name in ("raster_args_size", "raster_group_args_size",
                     "blur_args_size",
                     "tonemap_args_size", "blur_max_radius"):
            getattr(lib, name).restype = i32
        _library = lib
    return _library


def launcher(name: str, device: torch.device):
    """The kernel library's `name(args*, device, stream)` bound to `device`
    and its current stream: a function of the argument struct's address."""
    fn = getattr(load_library(), name)
    index = device.index if device.index is not None else 0
    stream = torch.cuda.current_stream(device).cuda_stream
    return lambda args: fn(args, index, stream)


def load_host_library() -> ctypes.CDLL:
    """Build (at first use) and load the host library."""
    global _host_library
    if _host_library is None:
        lib = ctypes.CDLL(str(build_host_library()))
        ptr, i64 = ctypes.c_void_p, ctypes.c_int64
        lib.bvh_build.argtypes = [ptr, ptr, ptr, i64, ctypes.c_int32, i64,
                                  ptr, ptr, ptr, ptr, ptr, ptr]
        lib.bvh_build.restype = i64
        # The mesh import helpers (assets/native.py).
        lib.weld_vertices.argtypes = [ptr, i64, ctypes.c_float, ptr]
        lib.weld_vertices.restype = i64
        lib.generate_normals.argtypes = [ptr, i64, ptr, i64, ptr]
        lib.generate_normals.restype = None
        lib.obj_count.argtypes = [ctypes.c_char_p, i64, ptr, ptr]
        lib.obj_count.restype = i64
        lib.obj_parse.argtypes = [ctypes.c_char_p, i64, ptr, ptr]
        lib.obj_parse.restype = i64
        _host_library = lib
    return _host_library


def resolve_device(device) -> torch.device:
    """`torch.device(device)`, refusing a CUDA device when there is none:
    the port's entry points default to the card and never fall back to the
    CPU quietly; pass `device="cpu"` to run on the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} requested but no CUDA device is available; "
            "pass device='cpu' to run the port on the CPU")
    return device
