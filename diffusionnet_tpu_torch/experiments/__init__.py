"""The experiment harness (`exp_common.fit`); the experiments'
command-line scripts come with ROADMAP item A.7."""
