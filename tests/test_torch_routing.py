"""Where the port's work runs is decided in one place: utils/device.py.

The three switches of the routing policy (the device, the DP switch, the
stage-1/2 opt-in) are read there and nowhere else in the package, and the
package reads no environment variable beyond the ones listed here.  A
variable counts as read where its name is a string constant of the code
(docstrings and messages hold longer strings).
"""
import ast
import os
import re

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "diamond_tpu_torch")

ROUTING = ("DIAMOND_TPU_TORCH_DEVICE", "DIAMOND_TPU_TORCH_DEVICE_DP",
           "DIAMOND_TPU_TORCH_STAGE12")
# every other variable the package reads -> the module that reads it
OTHERS = {
    "DIAMOND_TPU_TORCH_COORDINATOR_ADDRESS": "utils/device.py",
    "DIAMOND_TPU_TORCH_NUM_PROCESSES": "utils/device.py",
    "DIAMOND_TPU_TORCH_PROCESS_ID": "utils/device.py",
    "DIAMOND_TPU_TORCH_DIST_TIMEOUT": "utils/device.py",
    "DIAMOND_TPU_PROF": "utils/log.py",
    "DIAMOND_TPU_THP": "__init__.py",
    "DIAMOND_TPU_NO_NATIVE": "native/__init__.py",
    "DIAMOND_TPU_NATIVE_SO": "native/__init__.py",
    "DIAMOND_TPU_HIT_BUFFER_MB": "search/hit_buffer.py",
    "DIAMOND_TPU_SORT_MEM_MB": "cluster/multinode.py",
    "DIAMOND_TPU_MP_DIE_ON_CLAIM": "parallel/mp.py",
}


def _variables_read():
    """{variable name: {modules whose code names it}} over the package."""
    out = {}
    for root, dirs, files in os.walk(PORT):
        dirs[:] = [d for d in dirs if d not in ("build", "__pycache__")]
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(root, f)
            with open(path) as fh:
                tree = ast.parse(fh.read(), path)
            rel = os.path.relpath(path, PORT)
            for node in ast.walk(tree):
                if (isinstance(node, ast.Constant)
                        and isinstance(node.value, str)
                        and re.fullmatch(r"DIAMOND_TPU_\w+", node.value)):
                    out.setdefault(node.value, set()).add(rel)
    return out


def test_routing_switches_are_read_in_utils_device_only():
    read = _variables_read()
    for name in ROUTING:
        assert read.pop(name, None) == {"utils/device.py"}, name
    assert read == {k: {v} for k, v in OTHERS.items()}
