"""Device selection, human-facing metrics logging, seeding, and the
supervisor's restart loop with its backoff policy."""
