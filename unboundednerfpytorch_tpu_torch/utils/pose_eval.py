"""6-DoF object-pose evaluation (the LINEMOD metrics of ``--program
linemod_eval``).

The port's own copy of ``unboundednerfpytorch_tpu/utils/pose_eval.py``,
numpy and scipy only: ADD(-S) at 2, 5 and 10 % of the object's diameter,
the 2D projection error, the 5 cm / 5 degree metric, rotation-angle
measures, the LINEMOD constants (diameters, classes and the shared
intrinsics ``LINEMOD_K``, which the LINEMOD loader also reads), the object
model reader (``model_points.npy`` or a PLY file) and
:func:`evaluate_linemod_sequence`, which the command line drives. ICP
refinement is out of scope, as in the JAX package.
"""

from __future__ import annotations

import numpy as np

# LineMOD object diameters (cm) and intrinsics (pose_utils/linemod_constants.py)
LINEMOD_DIAMETERS = {
    "cat": 15.2633, "ape": 9.74298, "benchvise": 28.6908, "bowl": 17.1185,
    "cam": 17.1593, "camera": 17.1593, "can": 19.3416, "cup": 12.5961,
    "driller": 25.9425, "duck": 10.7131, "eggbox": 17.6364, "glue": 16.4857,
    "holepuncher": 14.8204, "iron": 30.3153, "lamp": 28.5155, "phone": 20.8394,
}
LINEMOD_CLASSES = [
    "ape", "cam", "cat", "duck", "glue", "iron", "phone", "benchvise",
    "can", "driller", "eggbox", "holepuncher", "lamp",
]
LINEMOD_K = np.array(
    [[572.4114, 0.0, 325.2611], [0.0, 573.57043, 242.04899], [0.0, 0.0, 1.0]]
)


def project(xyz: np.ndarray, K: np.ndarray, RT: np.ndarray) -> np.ndarray:
    """Project [N,3] model points with [3,4] pose and [3,3] intrinsics."""
    xyz = xyz @ RT[:, :3].T + RT[:, 3:].T
    xyz = xyz @ K.T
    return xyz[:, :2] / xyz[:, 2:]


def chordal_distance(R1, R2) -> float:
    return float(np.sqrt(np.sum((R1 - R2) ** 2)))


def rotation_angle_chordal(R1, R2) -> float:
    return float(2 * np.arcsin(chordal_distance(R1, R2) / np.sqrt(8)))


def rotation_angle_euler(R1, R2) -> float:
    """Norm of the euler angles of the difference rotation
    (linemod_evaluator.py:9-17)."""
    from scipy.spatial.transform import Rotation as R

    diff = R1 @ np.linalg.inv(R2)
    euler = R.from_matrix(diff).as_euler("zyx", degrees=True)
    return float(np.linalg.norm(euler))


def add_distance(model: np.ndarray, pose_pred: np.ndarray,
                 pose_target: np.ndarray, symmetric: bool = False) -> float:
    """Mean model-point distance under the two poses; symmetric variant uses
    nearest-neighbor matching (ADD-S)."""
    pred = model @ pose_pred[:, :3].T + pose_pred[:, 3]
    targ = model @ pose_target[:, :3].T + pose_target[:, 3]
    if symmetric:
        d2 = np.sum((pred[:, None, :] - targ[None, :, :]) ** 2, -1)
        idx = np.argmin(d2, axis=0)
        return float(np.mean(np.linalg.norm(pred[idx] - targ, axis=-1)))
    return float(np.mean(np.linalg.norm(pred - targ, axis=-1)))


class LineMODEvaluator:
    """Accumulating evaluator matching the reference API surface
    (linemod_evaluator.py:38-212, sans ICP)."""

    def __init__(self, class_name: str, model_points: np.ndarray):
        self.class_name = class_name
        self.model = np.asarray(model_points)
        self.diameter = LINEMOD_DIAMETERS[class_name] / 100.0
        self.proj2d: list[bool] = []
        self.add: list[bool] = []
        self.add2: list[bool] = []
        self.add5: list[bool] = []
        self.cmd5: list[bool] = []
        self.mask_ap: list[bool] = []

    def projection_2d(self, pose_pred, pose_target, K, threshold: float = 5):
        diff = np.mean(
            np.linalg.norm(
                project(self.model, K, pose_pred) - project(self.model, K, pose_target),
                axis=-1,
            )
        )
        self.proj2d.append(bool(diff < threshold))
        return diff

    def _add_at(self, pose_pred, pose_target, percentage, store, symmetric=False):
        mean_dist = add_distance(self.model, pose_pred, pose_target, symmetric)
        ok = mean_dist < self.diameter * percentage
        store.append(bool(ok))
        return mean_dist, ok

    def add_metric(self, pose_pred, pose_target, symmetric: bool = False,
                   percentage: float = 0.1):
        if pose_pred.ndim == 3:  # batch mode: best candidate counts
            dists = [
                add_distance(self.model, p, t, symmetric)
                for p, t in zip(pose_pred, pose_target)
            ]
            mean_dist = float(np.sort(dists)[0])
            ok = mean_dist < self.diameter * percentage
            self.add.append(bool(ok))
            return mean_dist, ok
        return self._add_at(pose_pred, pose_target, percentage, self.add, symmetric)

    def add2_metric(self, pose_pred, pose_target, symmetric: bool = False):
        return self._add_at(pose_pred, pose_target, 0.02, self.add2, symmetric)

    def add5_metric(self, pose_pred, pose_target, symmetric: bool = False):
        return self._add_at(pose_pred, pose_target, 0.05, self.add5, symmetric)

    def cm_degree_5_metric(self, pose_pred, pose_target):
        trans_cm = np.linalg.norm(pose_pred[:, 3] - pose_target[:, 3]) * 100
        rot_diff = pose_pred[:, :3] @ pose_target[:, :3].T
        trace = min(np.trace(rot_diff), 3.0)
        ang = np.rad2deg(np.arccos((trace - 1.0) / 2.0))
        self.cmd5.append(bool(trans_cm < 5 and ang < 5))
        return trans_cm, ang

    def mask_iou(self, mask_pred: np.ndarray, mask_gt: np.ndarray):
        iou = (mask_pred & mask_gt).sum() / max((mask_pred | mask_gt).sum(), 1)
        self.mask_ap.append(bool(iou > 0.7))
        return iou

    def evaluate(self, pose_pred, pose_target, K=None):
        """One-call per-frame evaluation: all pose metrics at once (the
        reference's evaluator accumulates these across its eval loop,
        linemod_evaluator.py:9-36, :335)."""
        K = LINEMOD_K if K is None else K
        symmetric = self.class_name in ("eggbox", "glue")  # standard LineMOD
        self.projection_2d(pose_pred, pose_target, K)
        self.add_metric(pose_pred, pose_target, symmetric=symmetric)
        self.add2_metric(pose_pred, pose_target, symmetric=symmetric)
        self.add5_metric(pose_pred, pose_target, symmetric=symmetric)
        self.cm_degree_5_metric(pose_pred, pose_target)

    def summarize(self) -> dict:
        mean = lambda xs: float(np.mean(xs)) if xs else float("nan")
        return {
            "proj2d": mean(self.proj2d),
            "add": mean(self.add),
            "add2": mean(self.add2),
            "add5": mean(self.add5),
            "cmd5": mean(self.cmd5),
            "mask_ap": mean(self.mask_ap),
        }


def load_model_points(seq_dir: str) -> np.ndarray:
    """Object model points for ADD metrics: ``model_points.npy`` or a
    (ascii/binary) ``*.ply`` under the sequence directory."""
    import glob
    import os

    npy = os.path.join(seq_dir, "model_points.npy")
    if os.path.exists(npy):
        return np.load(npy).astype(np.float64)
    plys = glob.glob(os.path.join(seq_dir, "*.ply"))
    if plys:
        return _read_ply_points(plys[0])
    raise FileNotFoundError(
        f"no model_points.npy or .ply under {seq_dir} for ADD evaluation"
    )


def _read_ply_points(path: str) -> np.ndarray:
    """Minimal PLY vertex reader (ascii + binary_little_endian float32)."""
    with open(path, "rb") as f:
        header = []
        while True:
            line = f.readline().decode("ascii", errors="replace").strip()
            header.append(line)
            if line == "end_header":
                break
        n_vert = 0
        fmt = "ascii"
        props = []
        in_vertex = False
        for line in header:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "format":
                fmt = parts[1]
            elif parts[0] == "element":
                in_vertex = parts[1] == "vertex"
                if in_vertex:
                    n_vert = int(parts[2])
            elif parts[0] == "property" and in_vertex:
                props.append((parts[1], parts[2]))
        if fmt == "ascii":
            rows = [f.readline().split()[: len(props)] for _ in range(n_vert)]
            arr = np.asarray(rows, dtype=np.float64)
        else:
            dt_map = {"float": "f4", "float32": "f4", "double": "f8",
                      "uchar": "u1", "uint8": "u1", "int": "i4", "uint": "u4"}
            dtype = np.dtype([(name, dt_map.get(t, "f4")) for t, name in props])
            raw = np.frombuffer(f.read(n_vert * dtype.itemsize), dtype=dtype)
            arr = np.stack(
                [raw[name].astype(np.float64) for name in ("x", "y", "z")], -1
            )
            return arr
    cols = {name: i for i, (_, name) in enumerate(props)}
    return arr[:, [cols["x"], cols["y"], cols["z"]]]


def evaluate_linemod_sequence(
    class_name: str,
    model_points: np.ndarray,
    pose_preds: np.ndarray,
    pose_gts: np.ndarray,
    K: np.ndarray | None = None,
) -> dict:
    """Drive the evaluator over a sequence of [N,3,4] predictions vs GT.

    The invocation surface the reference leaves implicit (its evaluator is
    only instantiated by unreleased experiment code) — wired here into the
    CLI ``linemod_eval`` program."""
    ev = LineMODEvaluator(class_name, model_points)
    for pred, gt in zip(np.asarray(pose_preds), np.asarray(pose_gts)):
        ev.evaluate(pred[:3, :4], gt[:3, :4], K)
    return ev.summarize()
