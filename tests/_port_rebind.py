"""Run a reference test against the port: the reference test's own code and
assertions, with the names it reads from its module rebound to the port's
objects.

``rebind(module, "test_x", Channel=port_Channel, ...)`` returns a copy of
``module.test_x`` whose globals are the module's with the given names
replaced; every other function of that module (the test's helpers) is
copied onto the same globals, so a helper that builds a ``PAL`` builds the
port's too.  Classes of the module keep their own globals: the reference
tests' toy kernels are numpy only.
"""
import types


def rebind(module, name: str, **names):
    missing = sorted(set(names) - set(vars(module)))
    if missing:
        raise KeyError(f"{module.__name__} reads no {missing}")
    g = dict(vars(module))
    g.update(names)
    for key, val in list(g.items()):
        if (key not in names and isinstance(val, types.FunctionType)
                and val.__module__ == module.__name__):
            fn = types.FunctionType(val.__code__, g, val.__name__,
                                    val.__defaults__, val.__closure__)
            fn.__kwdefaults__ = val.__kwdefaults__
            g[key] = fn
    return g[name]
