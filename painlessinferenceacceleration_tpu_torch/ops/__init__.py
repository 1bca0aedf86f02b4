"""Port of painlessinferenceacceleration_tpu.ops."""
