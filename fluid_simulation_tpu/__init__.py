"""The package's former import name, kept so that existing imports work.

Importing this package, or any submodule under it, warns once and returns
the very module objects of ``fluid_simulation``; nothing is imported twice.
New code imports ``fluid_simulation``.
"""

import importlib
import importlib.abc
import importlib.util
import sys
import warnings

_OLD, _NEW = __name__, "fluid_simulation"


class _Alias(importlib.abc.MetaPathFinder, importlib.abc.Loader):
    """Resolves ``<old>.x.y`` to the already-importable ``fluid_simulation.x.y``."""

    def find_spec(self, name, path=None, target=None):
        if name.startswith(_OLD + "."):
            return importlib.util.spec_from_loader(name, self)
        return None

    def create_module(self, spec):
        module = importlib.import_module(_NEW + spec.name[len(_OLD):])
        spec.loader_state = module.__spec__
        return module

    def exec_module(self, module):
        # the import system set __spec__ to the alias spec; restore it
        module.__spec__ = module.__spec__.loader_state


warnings.warn(f"'{_OLD}' is deprecated; import '{_NEW}' instead",
              DeprecationWarning, stacklevel=2)
sys.meta_path.insert(0, _Alias())
sys.modules[_OLD] = importlib.import_module(_NEW)
