from gdpathtracing.cli import main

main()
