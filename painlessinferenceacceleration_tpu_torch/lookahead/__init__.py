"""Port of painlessinferenceacceleration_tpu.lookahead."""
