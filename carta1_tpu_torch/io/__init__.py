"""Host file IO of the port: AEA read, int16 WAV write."""
