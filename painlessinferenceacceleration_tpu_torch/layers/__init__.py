"""Port of painlessinferenceacceleration_tpu.layers."""
