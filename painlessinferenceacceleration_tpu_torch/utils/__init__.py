"""Port of painlessinferenceacceleration_tpu.utils."""
