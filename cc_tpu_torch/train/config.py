"""Training configuration: the reference's argparse surface (train.py:34-135)
as a frozen dataclass, with the same fields and defaults as
cc_tpu/train/config.py (kept as a copy: the port imports nothing of cc_tpu).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    # network choices (train.py:84-91)
    dispnet: str = "DispResNet6"
    posenet: str = "PoseNetB6"
    masknet: str = "MaskNet6"
    flownet: str = "Back2Future"
    nlevels: int = 6

    # data / shapes
    sequence_length: int = 5
    height: int = 256
    width: int = 832
    batch_size: int = 4

    # optimization (train.py:65-72)
    lr: float = 2e-4
    momentum: float = 0.9          # adam beta1
    beta: float = 0.999            # adam beta2
    weight_decay: float = 0.0
    clip_grad_norm: float = 0.0    # global-norm clip, 0 = off (reference)
    skip_nonfinite_updates: bool = False

    # loss weights (train.py:120-130)
    cam_photo_loss_weight: float = 1.0    # -pc  (w1)
    mask_loss_weight: float = 0.0         # -m   (w2)
    smooth_loss_weight: float = 0.1       # -s   (w3)
    flow_photo_loss_weight: float = 1.0   # -pf  (w4)
    consensus_loss_weight: float = 0.1    # -c   (w5)
    qch: float = 0.5
    wrig: float = 1.0
    wbce: float = 0.5
    wssim: float = 0.0
    THRESH: float = 0.01
    lambda_oob: float = 0.0

    # modes (train.py:47-52, 77-82, 102-105)
    rotation_mode: str = "euler"
    padding_mode: str = "zeros"
    smoothness_type: str = "regular"      # 'regular' | 'edgeaware'
    spatial_normalize: bool = False
    no_non_rigid_mask: bool = False
    joint_mask_for_depth: bool = False

    # CC alternation freezes (train.py:107-114)
    fix_dispnet: bool = False
    fix_posenet: bool = False
    fix_masknet: bool = False
    fix_flownet: bool = False

    # compute
    compute_dtype: str = "float32"        # 'float32' | 'bfloat16' (nets)
    loss_dtype: str = "float32"           # 'float32' | 'bfloat16'

    @property
    def nb_ref_imgs(self) -> int:
        return self.sequence_length - 1

    def replace(self, **kw) -> "TrainConfig":
        return dataclasses.replace(self, **kw)
