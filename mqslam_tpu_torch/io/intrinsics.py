"""Camera-intrinsics file IO.

The reference stores intrinsics as an eval()-able Python repr of
``(cameraMatrix, distCoeffs, imageSize)`` (reference: Work/python_libs/
calibration_tools.py:23-56 — including a bare ``eval`` of file contents on
load). This module reads/writes the identical wire format but through a
restricted AST evaluator that only admits numeric literals, tuples/lists and
``array(...)`` calls — no arbitrary code execution.
"""

import ast

import numpy as np

__all__ = ["load_camera_intrinsics", "save_camera_intrinsics"]


def _safe_eval(node):
    if isinstance(node, ast.Expression):
        return _safe_eval(node.body)
    if isinstance(node, ast.Constant):
        if isinstance(node.value, (int, float)):
            return node.value
        raise ValueError(f"Disallowed constant: {node.value!r}")
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, (ast.USub,
                                                              ast.UAdd)):
        v = _safe_eval(node.operand)
        return -v if isinstance(node.op, ast.USub) else v
    if isinstance(node, ast.Tuple):
        return tuple(_safe_eval(e) for e in node.elts)
    if isinstance(node, ast.List):
        return [_safe_eval(e) for e in node.elts]
    if isinstance(node, ast.Call):
        if isinstance(node.func, ast.Name) and node.func.id == "array":
            args = [_safe_eval(a) for a in node.args]
            kwargs = {}
            for kw in node.keywords:
                if kw.arg != "dtype":
                    raise ValueError(f"Disallowed kwarg: {kw.arg}")
                if not (isinstance(kw.value, ast.Name)
                        or isinstance(kw.value, ast.Attribute)):
                    raise ValueError("Disallowed dtype expression")
                name = (kw.value.id if isinstance(kw.value, ast.Name)
                        else kw.value.attr)
                kwargs["dtype"] = np.dtype(name)
            return np.array(*args, **kwargs)
        raise ValueError("Only array(...) calls are allowed")
    raise ValueError(f"Disallowed syntax: {ast.dump(node)[:80]}")


def load_camera_intrinsics(filename):
    """Load ``(cameraMatrix [3,3], distCoeffs [k], imageSize (w, h))``.

    Same file format as calibration_tools.py:44-56, parsed safely.
    """
    with open(filename) as f:
        text = f.read()
    # Strip comments and the reference's trailing-backslash line continuations.
    lines = [ln for ln in text.split("\n") if not ln.strip().startswith("#")]
    src = "\n".join(lines).replace("\\\n", " ").replace("\\", " ")
    tree = ast.parse(src.strip(), mode="eval")
    cameraMatrix, distCoeffs, imageSize = _safe_eval(tree)
    cameraMatrix = np.asarray(cameraMatrix, dtype=np.float64)
    distCoeffs = np.asarray(distCoeffs, dtype=np.float64).reshape(-1)
    return cameraMatrix, distCoeffs, tuple(int(v) for v in imageSize)


def save_camera_intrinsics(filename, cameraMatrix, distCoeffs, imageSize):
    """Write the reference-compatible repr layout
    (calibration_tools.py:23-41)."""
    cameraMatrix = np.asarray(cameraMatrix, dtype=np.float64)
    distCoeffs = np.asarray(distCoeffs, dtype=np.float64).reshape(-1)
    with np.printoptions(threshold=np.inf, floatmode="maxprec"):
        out = ("# cameraMatrix, distCoeffs, imageSize =\n"
               "\n"
               f"{repr(cameraMatrix)}, \\\n"
               "\\\n"
               f"{repr(distCoeffs)}, \\\n"
               "\\\n"
               f"{tuple(int(v) for v in imageSize)!r}\n")
    with open(filename, "w") as f:
        f.write(out)
