"""Port of painlessinferenceacceleration_tpu.service: the HTTP server and client."""
