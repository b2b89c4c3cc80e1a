"""Small tools around the port: the software stack's fingerprint."""
