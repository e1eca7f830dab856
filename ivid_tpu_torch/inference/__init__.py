"""The multiview scene pipeline, viewsets and scene IO."""
