"""Port of painlessinferenceacceleration_tpu.models."""
