"""The ca_body codec-avatar render: pose + face codes → photoreal frames."""
