"""The host build of ``native/fastdata.c``, the loader's windowed reads.

``fastdata`` is a CPython extension in C (no kernel): it reads a window of
a 16-bit wav or of a float32 ``.npy`` straight from the file and z-normalises
it in the same loop, with the GIL released.  The JAX package builds it into
its own tree with ``native/build.sh``; the port never runs that script.  It
compiles the same source at first use with ``gcc -O3 -shared -fPIC`` and the
interpreter's include path into ``build/torch_host/`` at the root of the
checkout, under a name keyed by a hash of the source and the flags (as
``kernels/build.py`` keys the CUDA libraries), and loads it with
``importlib.machinery.ExtensionFileLoader``.  Nothing here runs when the
package is imported.
"""

from __future__ import annotations

import functools
import hashlib
import importlib.machinery
import importlib.util
import os
import subprocess
import sysconfig
import threading
from pathlib import Path
from types import ModuleType

ROOT = Path(__file__).resolve().parents[2]
SOURCE = ROOT / "native" / "fastdata.c"
BUILD_DIR = ROOT / "build" / "torch_host"
GCC_FLAGS = ("-O3", "-shared", "-fPIC")
# the extension's init symbol is PyInit_fastdata, so the module's name must end in it
MODULE_NAME = "fastdata"

_lock = threading.Lock()


def library_path() -> Path:
    """Where the extension for this source, these flags and this interpreter lives."""
    include = sysconfig.get_paths()["include"]
    h = hashlib.sha256(" ".join((*GCC_FLAGS, include)).encode())
    h.update(SOURCE.read_bytes())
    suffix = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    return BUILD_DIR / f"fastdata-{h.hexdigest()[:16]}{suffix}"


@functools.lru_cache(maxsize=None)
def fastdata() -> ModuleType:
    """The built ``fastdata`` module; raises with gcc's stderr when the
    build fails (and tries again at the next call)."""
    path = library_path()
    with _lock:
        if not path.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
            cmd = ["gcc", *GCC_FLAGS, f"-I{sysconfig.get_paths()['include']}", str(SOURCE), "-o", str(tmp)]
            try:
                proc = subprocess.run(cmd, capture_output=True, text=True)
            except OSError as e:  # no gcc
                raise RuntimeError(f"cannot build fastdata: {e}") from e
            if proc.returncode != 0:
                raise RuntimeError(f"gcc failed for fastdata (exit {proc.returncode}):\n{proc.stderr[-4000:]}")
            os.replace(tmp, path)  # atomic: a concurrent loader never sees half a file
    loader = importlib.machinery.ExtensionFileLoader(MODULE_NAME, str(path))
    spec = importlib.util.spec_from_file_location(MODULE_NAME, str(path), loader=loader)
    module = importlib.util.module_from_spec(spec)
    loader.exec_module(module)
    return module
