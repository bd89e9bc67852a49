from obman_train_tpu_torch.assets.contact_zones import (
    TIP_VERT_IDS,
    load_contact_zones,
    tips_mask,
    zone_masks,
)
from obman_train_tpu_torch.assets.icosphere import icosphere
from obman_train_tpu_torch.assets.mano_assets import (
    JOINT_REORDER,
    MANO_PARENTS,
    PALM_VERT_IDS,
    TIPS,
    ManoAssets,
    synthetic_mano_assets,
)

__all__ = [
    "JOINT_REORDER",
    "MANO_PARENTS",
    "PALM_VERT_IDS",
    "TIPS",
    "TIP_VERT_IDS",
    "ManoAssets",
    "icosphere",
    "load_contact_zones",
    "synthetic_mano_assets",
    "tips_mask",
    "zone_masks",
]
