"""Chain state and the composable transition protocol."""
