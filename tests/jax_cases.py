"""Run the JAX package's own unit cases against the port.

`port_copy("test_obs")` executes a JAX test module's source anew in a
fresh namespace whose imports of `walkai_nos_tpu.X` resolve to
`walkai_nos_tpu_torch.X`, at module level and inside functions alike.
Its classes and helpers then exercise the port's objects with the JAX
tests' own scripts and assertions, unchanged. A module or a name the
port does not have stays the JAX package's: the cases run from the copy
use none of them.

`run_case` calls one test method of such a class, handing it the pytest
fixtures it names.
"""

import builtins
import importlib
import inspect
import types
from pathlib import Path

HERE = Path(__file__).resolve().parent


def _port_name(name: str) -> str:
    if name == "walkai_nos_tpu" or name.startswith("walkai_nos_tpu."):
        return "walkai_nos_tpu_torch" + name[len("walkai_nos_tpu"):]
    return name


def _import(name, globals=None, locals=None, fromlist=(), level=0):
    port = _port_name(name)
    if level or port == name:
        return builtins.__import__(name, globals, locals, fromlist, level)
    try:
        mod = importlib.import_module(port)
    except ModuleNotFoundError:
        return builtins.__import__(name, globals, locals, fromlist, level)
    if not fromlist:
        return builtins.__import__(port, globals, locals, fromlist, level)
    for n in fromlist:
        if n != "*" and not hasattr(mod, n):
            try:  # a submodule
                importlib.import_module(f"{port}.{n}")
            except ModuleNotFoundError:
                pass
    missing = [n for n in fromlist if n != "*" and not hasattr(mod, n)]
    if not missing:
        return mod
    # Names the port's module lacks come from the JAX module.
    merged = types.ModuleType(port)
    vars(merged).update(vars(mod))
    jmod = importlib.import_module(name)
    for n in missing:
        setattr(merged, n, getattr(jmod, n))
    return merged


def port_copy(module: str) -> dict:
    """The namespace of `tests/<module>.py` executed against the port."""
    path = HERE / f"{module}.py"
    namespace = {
        "__name__": f"port_copy_of_{module}",
        "__file__": str(path),
        "__builtins__": {**vars(builtins), "__import__": _import},
    }
    exec(compile(path.read_text(), str(path), "exec"), namespace)
    return namespace


def cases(namespace: dict, classes, exclude=()) -> list[tuple[str, str]]:
    """(class, method) of every `test_*` method of `classes`, less
    `exclude` ("Class.method")."""
    return [
        (cls, name)
        for cls in classes
        for name in sorted(vars(namespace[cls]))
        if name.startswith("test_") and f"{cls}.{name}" not in exclude
    ]


def run_case(namespace: dict, cls: str, name: str, request) -> None:
    method = getattr(namespace[cls](), name)
    kwargs = {
        p: request.getfixturevalue(p)
        for p in inspect.signature(method).parameters
    }
    method(**kwargs)
