"""Device selection and human-facing metrics logging."""
