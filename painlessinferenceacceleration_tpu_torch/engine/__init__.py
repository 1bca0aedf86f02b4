"""Port of painlessinferenceacceleration_tpu.engine."""
