"""Plain numpy helpers of the port: skeleton tables and crop geometry."""
