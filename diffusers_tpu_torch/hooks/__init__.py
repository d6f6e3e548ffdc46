from .faster_cache import (
    FasterCacheConfig,
    FasterCacheState,
    denoise_loop_faster_cache,
    faster_cache_apply,
    faster_cache_apply_pair,
    faster_cache_schedules,
    init_faster_cache_state,
)
from .first_block_cache import (
    FBCSingleState,
    FBCState,
    FirstBlockCacheConfig,
    fbc_single_gate,
    flux_forward_with_fbc,
    init_fbc_single_state,
    init_fbc_state,
)
from .generic_cache import TextKVCacheConfig, denoise_loop, denoise_loop_with_callback, text_kv_cache
from .mag_cache import (
    FLUX_MAG_RATIOS,
    MagCacheConfig,
    MagCacheState,
    flux_forward_with_magcache,
    init_mag_cache_state,
    mag_cache_compute_mask,
)
from .pyramid_attention_broadcast import PyramidAttentionBroadcastConfig, pab_compute_mask
from .taylorseer import (
    TaylorSeerCacheConfig,
    TaylorSeerState,
    init_taylorseer_state,
    taylorseer_apply,
    taylorseer_compute_mask,
)
