"""Advanced diffusion configuration — a plain copy of
``diffbinaural_tpu/core/advanced_diffusion_config.py``, the reference's dead
config module (no shipped script imports it).  Kept for the inventory: it
documents the intended hyper-parameters (CFG scale 7.5, EMA 0.9999, the
improved-cosine schedule, multi-scale loss weights)."""

from __future__ import annotations


class AdvancedDiffusionConfig:
    MODEL_CONFIG = {
        "dim": 128,
        "init_dim": 128,
        "out_dim": 2,
        "channels": 2,
        "self_condition": True,
        "resnet_block_groups": 8,
        "learned_variance": False,
        "use_enhanced_attention": True,
        "use_multi_scale_loss": True,
    }

    DIFFUSION_CONFIG = {
        "timesteps": 1000,
        "sampling_timesteps": 25,
        "loss_type": "l1",
        "objective": "pred_noise",
        "beta_schedule": "improved_cosine",
        "ddim_sampling_eta": 0,
        "auto_normalize": False,
        "min_snr_loss_weight": False,
    }

    CFG_CONFIG = {
        "cfg_scale": 7.5,
        "use_cfg": True,
        "uncond_dropout": 0.1,
        "cfg_training": True,
    }

    TRAINING_CONFIG = {
        "batch_size": 8,
        "learning_rate": 1e-4,
        "weight_decay": 1e-6,
        "gradient_clip": 1.0,
        "ema_decay": 0.9999,
        "warmup_steps": 1000,
        "scheduler_t0": 1000,
        "scheduler_t_mult": 2,
        "scheduler_eta_min": 1e-6,
    }

    MULTI_SCALE_CONFIG = {
        "scales": [1, 2, 4],
        "weights": [1.0, 0.5, 0.25],
    }

    ATTENTION_CONFIG = {
        "spatial_temporal_heads": 8,
        "spatial_temporal_dim_head": 64,
        "cross_modal_heads": 8,
        "cross_modal_dim_head": 64,
        "dropout": 0.1,
    }

    NOISE_SCHEDULE_CONFIG = {
        "num_timesteps": 1000,
        "beta_start": 1e-4,
        "beta_end": 0.02,
        "cosine_offset": 0.008,
        "cosine_scale": 1.008,
        "use_improved_schedule": True,
    }

    SAMPLING_CONFIG = {
        "use_cfg": True,
        "cfg_scale": 7.5,
        "ddim_steps": 25,
        "eta": 0.0,
        "silence_mask_sampling": True,
        "dynamic_threshold": False,
        "dynamic_threshold_percentile": 0.95,
    }

    EVAL_CONFIG = {
        "eval_epoch": 5,
        "save_freq": 10,
        "vis_freq": 5,
        "metrics": ["l2_distance", "mel_l2"],
    }

    ADVANCED_TECHNIQUES = {
        "use_ema": True,
        "use_improved_schedule": True,
        "use_cfg_training": True,
        "use_cfg_sampling": True,
        "use_multi_scale_loss": True,
        "use_enhanced_attention": True,
        "use_weighted_loss": True,
    }

    @classmethod
    def get_model_config(cls):
        return cls.MODEL_CONFIG

    @classmethod
    def get_diffusion_config(cls):
        return cls.DIFFUSION_CONFIG

    @classmethod
    def get_cfg_config(cls):
        return cls.CFG_CONFIG

    @classmethod
    def get_training_config(cls):
        return cls.TRAINING_CONFIG

    @classmethod
    def get_multi_scale_config(cls):
        return cls.MULTI_SCALE_CONFIG

    @classmethod
    def get_attention_config(cls):
        return cls.ATTENTION_CONFIG

    @classmethod
    def get_noise_schedule_config(cls):
        return cls.NOISE_SCHEDULE_CONFIG

    @classmethod
    def get_sampling_config(cls):
        return cls.SAMPLING_CONFIG

    @classmethod
    def get_eval_config(cls):
        return cls.EVAL_CONFIG

    @classmethod
    def get_advanced_techniques(cls):
        return cls.ADVANCED_TECHNIQUES
