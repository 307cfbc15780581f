"""Device selection and weight carry."""
