"""Run a JAX-package test module's cases against the port's copies.

``load(name)`` reads ``tests/<name>.py``, points every ``edl_tpu.``
import at ``edl_tpu_torch.`` (and ``-m tools.X`` at the port's
``-m edl_tpu_torch.tools.X``) and executes the result as a module of its
own; nothing of the JAX package is imported by it. ``cases(mod, ...)``
lists its test functions and methods as ``Class::method`` ids for
``pytest.mark.parametrize``; ``run(mod, case, request)`` calls one,
resolving its arguments as fixtures of the calling test module (which
supplies ``store`` and re-exports the module's own fixtures). The cases
are the JAX tests as written: their assertions hold the port to the
JAX package's behaviour, table by table.
"""

import inspect
import os
import re
import types

HERE = os.path.dirname(os.path.abspath(__file__))


def load(name: str) -> types.ModuleType:
    path = os.path.join(HERE, name + ".py")
    with open(path) as fh:
        src = fh.read()
    src = re.sub(r"\bedl_tpu\.", "edl_tpu_torch.", src)
    src = re.sub(r'"tools\.(\w+)"', r'"edl_tpu_torch.tools.\1"', src)
    mod = types.ModuleType("port_" + name)
    mod.__file__ = path
    exec(compile(src, path, "exec"), mod.__dict__)
    return mod


def cases(mod, classes=(), functions=()):
    """``Class::method`` for every ``test_*`` method of ``classes``, and
    the ``functions`` named."""
    out = []
    for cls in classes:
        for name, _fn in inspect.getmembers(getattr(mod, cls),
                                            inspect.isfunction):
            if name.startswith("test_"):
                out.append("%s::%s" % (cls, name))
    for name in functions:
        getattr(mod, name)  # a typo fails at collection
        out.append(name)
    return out


def run(mod, case: str, request) -> None:
    if "::" in case:
        cls, name = case.split("::")
        fn = getattr(getattr(mod, cls)(), name)
    else:
        fn = getattr(mod, case)
    kwargs = {p: request.getfixturevalue(p)
              for p in inspect.signature(fn).parameters}
    fn(**kwargs)
