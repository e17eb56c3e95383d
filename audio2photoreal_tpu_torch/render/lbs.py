"""Linear blend skinning with level-parallel forward kinematics.

Counterpart of ``audio2photoreal_tpu/render/lbs.py`` (reference:
visualize/ca_body/utils/lbs.py): pose → 7-per-joint channel params by a
transform matrix + offsets, forward kinematics one topological LEVEL of the
skeleton at a time, weighted 3×4 skinning transforms, and inverse skinning
by batched 4×4 inverses.  Joint state layout: translation(3) +
quaternion(4, xyzw) + scale(1).

``LBSModule`` keeps its static tables as non-persistent buffers, so it moves
with ``.to(device)`` and adds nothing to a state_dict.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from audio2photoreal_tpu_torch.render import quaternion as quat


@dataclass(frozen=True)
class Skeleton:
    """Static skeleton description (host-side numpy)."""

    joint_parents: np.ndarray  # [J] int, -1 = root
    joint_offset: np.ndarray  # [J, 3]
    joint_rotation: np.ndarray  # [J, 4] pre-rotation quats (xyzw)
    levels: Tuple[np.ndarray, ...]  # topological groups of joint indices

    @classmethod
    def create(cls, parents, offset, rotation) -> "Skeleton":
        parents = np.asarray(parents, np.int64).reshape(-1)
        depth = np.zeros_like(parents)
        for j, p in enumerate(parents):
            depth[j] = 0 if p < 0 else depth[p] + 1
        levels = tuple(np.where(depth == d)[0] for d in range(int(depth.max()) + 1))
        return cls(parents, np.asarray(offset, np.float32), np.asarray(rotation, np.float32), levels)

    @property
    def num_joints(self) -> int:
        return len(self.joint_parents)


def param_transform(pose: torch.Tensor, transform: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """[B, P] raw pose → [B, 7·J] channel params (lbs.py:47-54)."""
    return pose @ transform.T + offsets


def solve_skeleton_state(skel: Skeleton, params: torch.Tensor) -> torch.Tensor:
    """[B, 7·J] → [B, J, 8] global joint states, one skeleton level per step."""
    B = params.shape[0]
    jp = params.reshape(B, skel.num_joints, 7)
    offset = torch.as_tensor(skel.joint_offset, device=params.device)
    rotation = torch.as_tensor(skel.joint_rotation, device=params.device)
    lt = jp[:, :, 0:3] + offset[None]
    lr = quat.mul(rotation[None], quat.from_xyz(jp[:, :, 3:6]))
    ls = 2.0 ** jp[:, :, 6:7]
    gt, gr, gs = lt.clone(), lr.clone(), ls.clone()
    parents = torch.as_tensor(skel.joint_parents, device=params.device)
    for level in skel.levels[1:]:
        idx = torch.as_tensor(level, device=params.device)
        par = parents[idx]
        p_t, p_r, p_s = gt[:, par], gr[:, par], gs[:, par]
        gt[:, idx] = quat.rotate(p_r, lt[:, idx] * p_s) + p_t
        gr[:, idx] = quat.mul(p_r, lr[:, idx])
        gs[:, idx] = p_s * ls[:, idx]
    return torch.cat([gt, gr, gs], dim=-1)


def states_to_matrix(bind_state: torch.Tensor, target_states: torch.Tensor) -> torch.Tensor:
    """[B?, J, 8] bind + [B, J, 8] target → [B, J, 3, 4] skinning transforms
    (lbs.py:357-397): M = target ∘ bind⁻¹."""
    br = quat.invert(bind_state[..., 3:7])
    bs = 1.0 / bind_state[..., 7:8]
    bt = quat.rotate(br, -bind_state[..., 0:3]) * bs
    tr = quat.mul(target_states[..., 3:7], br)
    ts = target_states[..., 7:8] * bs
    tt = quat.rotate(target_states[..., 3:7], bt * target_states[..., 7:8]) + target_states[..., 0:3]
    rot = quat.to_matrix(tr) * ts[..., None]  # [B, J, 3, 3] scaled rotation
    return torch.cat([rot, tt[..., None]], dim=-1)  # [B, J, 3, 4]


def _blend(mat: torch.Tensor, skin_indices: torch.Tensor, skin_weights: torch.Tensor) -> torch.Tensor:
    vmat = mat[:, skin_indices]  # [B, V, K, 3, 4]
    return (vmat * skin_weights[None, :, :, None, None]).sum(dim=2)  # [B, V, 3, 4]


def skinning(mat, verts, skin_indices, skin_weights) -> torch.Tensor:
    """Weighted transform of vertices (lbs.py:215-241): the K per-vertex
    transforms are blended first, then applied once."""
    blended = _blend(mat, skin_indices, skin_weights)
    v = verts.expand(mat.shape[0], -1, -1)
    return torch.einsum("bvij,bvj->bvi", blended[..., :3], v) + blended[..., 3]


def unskinning(mat, verts_posed, skin_indices, skin_weights) -> torch.Tensor:
    """Inverse skinning via batched 4×4 inverses (lbs.py:260-290)."""
    blended = _blend(mat, skin_indices, skin_weights)
    B, V = blended.shape[:2]
    bottom = torch.zeros((B, V, 1, 4), dtype=blended.dtype, device=blended.device)
    bottom[..., 0, 3] = 1.0
    inv = torch.linalg.inv(torch.cat([blended, bottom], dim=-2))
    return torch.einsum("bvij,bvj->bvi", inv[..., :3, :3], verts_posed) + inv[..., :3, 3]


class LBSModule(nn.Module):
    """pose/unpose around a template (reference LBSModule, lbs.py:796-827)."""

    def __init__(
        self,
        skel: Skeleton,
        transform,  # [7J, P]
        transform_offsets,  # [7J]
        skin_indices,  # [V, K]
        skin_weights,  # [V, K]
        template_verts,  # [V, 3] or [1, V, 3]
    ):
        """The bind state is solved from an all-zero pose (lbs.py:112-115).
        The reference's global scaling is 1 for the synthetic person; real
        per-person assets, which carry another, are not ported yet."""
        super().__init__()
        self.skel = skel
        f32 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32)  # noqa: E731
        transform = f32(transform)
        offsets = f32(transform_offsets)
        params0 = param_transform(torch.zeros((1, transform.shape[1])), transform, offsets)
        tv = f32(template_verts)
        self.register_buffer("transform", transform, persistent=False)
        self.register_buffer("transform_offsets", offsets, persistent=False)
        self.register_buffer("bind_state", solve_skeleton_state(skel, params0), persistent=False)
        self.register_buffer("skin_indices", torch.as_tensor(np.asarray(skin_indices), dtype=torch.long),
                             persistent=False)
        self.register_buffer("skin_weights", f32(skin_weights), persistent=False)
        self.register_buffer("template_verts", tv[None] if tv.dim() == 2 else tv, persistent=False)

    def _matrices(self, pose: torch.Tensor) -> torch.Tensor:
        states = solve_skeleton_state(self.skel, param_transform(pose, self.transform, self.transform_offsets))
        return states_to_matrix(self.bind_state, states)

    def pose(self, verts_unposed: Optional[torch.Tensor], pose: torch.Tensor) -> torch.Tensor:
        """Skin (delta + template): ``verts_unposed`` is a DELTA from the
        template (lbs.py:809-813)."""
        verts = self.template_verts if verts_unposed is None else verts_unposed + self.template_verts
        return skinning(self._matrices(pose), verts, self.skin_indices, self.skin_weights)

    def unpose(self, verts_posed: torch.Tensor, pose: torch.Tensor) -> torch.Tensor:
        """Posed verts → DELTA from template (lbs.py:815-821)."""
        mat = self._matrices(pose)
        return unskinning(mat, verts_posed, self.skin_indices, self.skin_weights) - self.template_verts

    def template_pose(self, pose: torch.Tensor) -> torch.Tensor:
        return self.pose(None, pose)
