"""The benchmark's plain reference: `check.Judge` over the frozen copies in
`zkm/` (their headers name each source file, at commit 8cde39b)."""
