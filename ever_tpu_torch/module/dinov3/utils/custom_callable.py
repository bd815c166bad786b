"""``ever.module.dinov3.utils.custom_callable`` in the port: load a
callable from a user's Python file."""

import importlib.util
import os
import sys
from contextlib import contextmanager

__all__ = ['load_custom_callable', 'change_working_dir_and_pythonpath']


@contextmanager
def change_working_dir_and_pythonpath(new_dir: str):
    old_cwd = os.getcwd()
    old_path = list(sys.path)
    try:
        os.chdir(new_dir)
        sys.path.insert(0, new_dir)
        yield
    finally:
        os.chdir(old_cwd)
        sys.path[:] = old_path


def load_custom_callable(file_path: str, callable_name: str):
    file_path = os.path.abspath(file_path)
    with change_working_dir_and_pythonpath(os.path.dirname(file_path)):
        spec = importlib.util.spec_from_file_location('_ever_custom', file_path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    return getattr(mod, callable_name)
